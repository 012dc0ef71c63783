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
   launched the decode kernel once per layer, and that a short trace at
   cut depth 4 gives the same tokens with the kernel and with the plain
   oracle;
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
   tokens equal); at cut depth 4, (b) the main path's trace sampled at
   temperature 0.7, uncontended and oversubscribed on a pool too small
   for the worst-case reservations: at least one preemption, the
   uncontended run's tokens, one decode launch per layer per decode tick
   in both runs; (c) speculative serving at temperature 0.7 with drafts
   replaying (b)'s uncontended tokens, and with the n-gram drafter on the
   speculative phase's repeated-pattern trace, gives the plain sampled
   tokens.  Prints tokens/s, the sampled decode tick, preemptions and
   recomputed tokens, and the sampler's ms and launches per tick;
8. chaos path: (a) the main trace, greedy, at cut depth 4 (the plan's
   ticks depend on the schedule alone), through
   ``serving.serve_with_chaos`` on an oversubscribed engine with a snapshot
   every 8 ticks, under a crash mid-prefill, a forced pool-dry preemption,
   an interrupted snapshot write, a kernel fault (the circuit breaker
   switches that engine to the plain oracle) and a crash three ticks
   later: the undisturbed run's tokens at that depth, the plan fired
   whole, one degradation, decode launches 4 x the decode forwards of
   engines on the kernel;
   (b) the speculative phase's n-gram trace at the cut depth (4) of its
   fused-vs-plain check, drafted as there by replaying the plain tokens,
   under a drafter failure and a crash among its verify ticks: its plain
   tokens at that depth; (c) a short serve at
   page_size=12, a planeless pool, with no paged kernel launched.  Prints
   the wall time of each restore and what it recomputed, snapshot bytes
   and ms per write, and degraded against fused tick times;
9. memory path, at cut depth 4: (a) the sampled path's oversubscribed
   run again with a swap tier (``swap_host_bytes``): the victim swaps out
   and back in, with the uncontended tokens at that depth, fewer prefill
   chunks than the sampled path's recompute run (the schedule depends on
   the prompt lengths alone), the swap pool empty at the end and one
   decode launch per layer per tick;
   (b) a 256-token system prompt with four tails, greedy at one slot: a
   cold engine on an empty prefix store flushes its registered blocks, and
   a fresh warm engine on that store gives the cold tokens, every scale and
   every plane byte equal, with fewer prefill chunks; (b') the same at four
   slots, measured only (tokens equal or not, the largest relative gap
   between the grids); (c) a snug pool with a host prefix
   tier of about one record spills to disk, and a warm engine on the store
   gives a cold one's tokens.  Prints ms and bytes per swap-out and
   swap-in and per prefix record written and loaded, and
   ``memory_report()`` after (a) and (c);
10. front door path, at cut depth 4 (widths kept): (a) the main trace
   submitted to an ``AsyncFrontDoor`` over a paged engine and streamed:
   the plain tokens at that depth, admission in arrival order, the pool
   drained, one decode launch per layer per tick; (b) the same through a
   ``DisaggController`` (a one-slot prefill engine hands detached prefixes
   to a four-slot decode engine): the same tokens, 8 prefixes of 147
   blocks and 147 x 1,048,832 payload bytes, both pools drained, decode
   launches 4 x the decode engine's ticks and none by the prefill engine;
   (c) the ``prefill -> insert -> generate_step`` loop gives
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
12. dense path: the main trace at full width and cut depth 4 through (a)
   ``PagedEngine`` on ``attn_impl="xla"``, (b) ``ContinuousBatchingEngine``
   on ``xla`` (its tokens equal (a)'s, or first differ at a near-tie of
   (a)'s logits: a gap of at most 1e-3 of max |logit|), (c)
   ``ContinuousBatchingEngine`` on ``bitstopper_xla``, (d)
   ``StaticBucketEngine`` on ``xla`` sampled at
   0.7 (its sampler's first key, bits and tokens equal to the CPU's) and
   (e) the contiguous cache's resident bytes against the paged pool's
   peak; no kernel of the port launches on it;
13. bf16 caches (``ServeConfig.cache_dtype="bfloat16"``): (a) right after
   the large-page phase, the decode and verify kernels' bf16-V forms at
   the kernel shape (bs=16) and on the striped walk (bs=512) against their
   plain versions (rounds, survivors and v_fetched equal, out within
   OUT_TOL and bit-equal to the f32 form on the widened pool, every verify
   query equal to the bf16 decode, V bytes requested as designed and half
   the f32 form's), each timed alone beside the f32 form and its bound;
   after the dense path, (b) the main trace at full width and cut depth 4
   on a bf16 cache (4 decode launches a tick, tokens/s, the decode tick,
   the byte reports against the f32 main path's per layer), (c) at cut
   depth 4 a short trace with the kernel and with the plain oracle (equal
   tokens), the main trace speculatively with replayed drafts, the sampled oversubscribed run with a swap tier and a prefix
   store cold then warm at one slot (equal tokens, scales and planes), (d)
   the contiguous engine on ``xla`` against the paged one (the dense
   path's near-tie rule) and its resident bytes, half the f32 cache's;
14. the model zoo, after the stablelm phases release the card's memory:
   (a) right after the bf16 kernels, the decode and verify kernels at a
   qwen2-moe-a2.7b attention layer's shape (B=4, Hq=Hkv=16, D=128, pages
   of 16) held and timed as at D=64, and the cache-free kernels at one
   layer of its forward (2 x 16 heads of 128, S=1024; bitstopper_qk's
   rounds and survivors equal to plain, both outs within UNCACHED_TOL),
   timed beside their bounds; (b) full-width, full-depth
   qwen2-moe-a2.7b (f32, about 56 GB of seeded random weights drawn on the
   card) serving the main trace through ``PagedEngine`` with the decode
   kernel (24 launches a decode tick; tokens/s, the decode tick and the
   prefill chunk, dropped (token, expert) pairs per tick kind) and a
   profile of its decode ticks (device busy share); at cut depth 4, kernel
   against oracle (equal tokens) and replayed speculation at the config's
   capacity factor (the plain tokens, or verify forwards that dropped
   pairs: ROADMAP C9) and at a factor no call can bind (the plain tokens;
   4 verify launches a verify forward); the cache-free forward of 2 x
   1024 tokens at every impl (24 launches per kernel impl, argmax equal
   to the plain impl's at every position); (c) recurrentgemma-2b and
   mamba2-130m at full depth, deepseek-v3 cut to its three dense MLA
   layers (bf16): a finite cache-free forward and 12 single-token cached
   decode steps within 2e-3 of the forward (deepseek on its weights
   widened to f32; its bf16 run and MLA on ``bitstopper_xla`` reported
   against that), the MTP head finite;
15. mesh serving: (a) right after the MoE kernels, the decode and verify
   kernels at the main shape and on each shard of a 2x2 (data, model)
   mesh at its local geometry (2 slots, 16 heads): each shard's out
   bit-equal to its block of the full run, its per-head rounds, survivors
   and V pages equal, the full slot-wide rounds the max over the "model"
   shards, each shard timed alone beside its bound, and the same at
   qwen2-moe-a2.7b's attention shape (shards of 2 slots, 8 heads of 128);
   (b) after the forward path, full-width ``stablelm-1.6b`` cut to depth
   4 on a 2x2 mesh of four ranks sharing the card over gloo
   (``launch/mesh.py``; weights by CUDA IPC, their checksums equal to the
   parent's): a greedy trace (the main trace's four shortest prompts, 8
   new tokens) through the decode kernel and the same prompts with drafts
   replaying its tokens (k=4) through the verify kernel, each rank with
   16 of 32 KV heads: the parent's single-device tokens and bailouts on
   every rank, and each kernel launched 4 x the rank's
   forwards of its kind; then, in the same spawn, the mesh state: the
   main trace on an oversubscribed pool with a swap tier, the memory
   path's store trace cold on the mesh and warm from one device's store,
   the greedy trace through ``serve_with_chaos`` with a crash, its tick-4
   snapshot restored on a 1x2 mesh, and an ``insert`` of single-device
   prefills: single-device tokens, counters and reports, store and
   snapshot files byte-equal to one device's, and one device warming from
   the mesh's store and restoring its snapshot; prints each rank's decode
   tick, all-gather ms per layer and swap, record and restore ms; (c)
   after the MoE path, qwen2-moe-a2.7b at full width cut to depth 4 on the
   2x2 mesh (its weights by CUDA IPC), under the expert-parallel and the
   resident branch: single-device tokens, dropped pairs summed over each
   expert group, 8 of 16 KV heads and views of its experts' block (bytes
   printed), the first layer's FFN out bit-equal to one device's, 4
   decode launches a tick, and replayed speculation's
   single-device tokens with 4 verify launches a verify tick; prints the
   combine's gather ms per MoE layer;
16. baselines, right after the forward path: the paper's comparison on
   layer 0's q, k and v of full-width stablelm-1.6b over one 1024-token
   prompt (32 heads of 64, causal): dense INT12, Sanger, SOFA, TokenPicker
   and BESF (``core/baselines.py``, ``core/besf.py``) on the card and on
   the CPU, every mask and fetch counter equal and ``out`` within
   OUT_TOL; prints each method's ``core/stats.py`` Complexity in both
   accounting modes and BESF's K+V bytes and bit-MACs relative to the
   others (counts on random weights, not times);
17. train, last: stablelm-1.6b at its published width, f32, AdamW in f32:
   (a) full depth through ``train.trainer.Trainer`` at the launcher's
   defaults (batch 8, seq 256, 4 steps; ms per step, tokens/s, peak
   memory, loss and grad norm per step, the final checkpoint's bytes and
   ms), then one forward and backward under each remat policy from the
   trained state (losses and grad norms equal; peak memory of each); (b)
   depth 2, one 1 x 128 batch: the card's loss and global grad norm within
   TRAIN_CPU_TOL of the CPU's; (c) depth 2 under
   ``torch.use_deterministic_algorithms``: train(4) equal bit for bit to
   train(2) and a resumed train(2) (checkpoint bytes, save and load ms);
18. prints one JSON line describing each kernel (the bf16 forms, the
   D=128 shapes and the mesh shards under each kernel's row), then the
   device line last.

Any failed check exits non-zero.  Without a card it exits non-zero and
prints no result.  ``--profile`` instead profiles decode ticks, a prefill
chunk, verify ticks and one cache-free forward with each attention kernel
(device time by kernel, busy share); ``--train`` runs only the baselines
and train phases (no kernel build, no result line).
"""

from __future__ import annotations

import argparse
import gc
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
           "flash_attention", "paged_decode_bf16", "paged_verify_bf16")
BF16 = "bfloat16"                # ServeConfig.cache_dtype of the bf16 phases
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
    kept alive per (slot, KV head, page), the V pages with a survivor (at
    the V pool's value size), the small operands once, the outputs
    once."""
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
    nbytes = planes * bs8 * D + live_v * bs * Dv * v.element_size() + small \
        + outs
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


DECODE_SHAPES = dict(B=4, Hq=32, D=64, bs=16, MB=32, P=129)
DECODE_CASES = [("mha a=0.6", 0.6, 32, None), ("mha a=0.8", 0.8, 32, None),
                ("gqa Hkv=8", 0.6, 8, None), ("window 100", 0.8, 32, 100)]
# A qwen2-moe-a2.7b attention layer on the MoE path's decode ticks.
MOE_SHAPES = dict(B=4, Hq=16, D=128, bs=16, MB=32, P=129)
MOE_DECODE_CASES = [("qwen2-moe a=0.6", 0.6, 16, None)]
MOE_VERIFY_CASES = [("qwen2-moe a=0.6", 0.6, 16, 16, None)]


@phase("kernels")
def kernel_phase(torch):
    return decode_kernel_check(torch, DECODE_SHAPES, DECODE_CASES, 100)


def decode_kernel_check(torch, shapes, cases, seed):
    """paged_decode against its plain version on each case (label, alpha,
    Hkv, window) at ``shapes``; the first case timed alone, beside its
    wrapper, its plain version and its bound, with the bytes it counted
    held to the design's."""
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import paged_decode as pd
    worst = 0.0
    for i, (label, alpha, hkv, window) in enumerate(cases):
        cfg = BitStopperConfig(alpha=alpha)
        args = decode_case(torch, seed + i, Hkv=hkv, **shapes)
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
    cfg = BitStopperConfig(alpha=cases[0][1])
    args = decode_case(torch, seed, Hkv=cases[0][2], **shapes)
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
    print(f"[chip_smoke] paged_decode timing (B={B}, Hq={Hq}, Hkv={Hkv}, "
          f"D={D}, bs={bs}, MB={shapes['MB']}): wrapper {ms:.4f} ms, "
          f"kernel alone {kernel_ms:.4f} ms, "
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
    nbytes = (union * bs8 * D + v_union * bs * Dv * v.element_size() + small
              + outs)
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
    return (pages * Hkv * bits * bs8 * D,
            live * bs * Dv * v.element_size())


@phase("verify kernel")
def verify_kernel_phase(torch):
    """paged_verify against its plain version on draft blocks (padding
    queries, a row ending mid-page, an idle slot) at G = 1, 3, 4, 5 and 8,
    query by query against the paged_decode kernel at the query's position,
    and its own count of the bytes it copied against the design's."""
    shapes = dict(DECODE_SHAPES, Sq=SPEC_K + 1)
    del shapes["Hq"]
    cases = [("mha a=0.6", 0.6, 32, 32, None), ("gqa Hkv=8", 0.6, 32, 8, None),
             ("window 100", 0.8, 32, 32, 100), ("G=3", 0.6, 24, 8, None),
             ("G=5", 0.6, 40, 8, None), ("G=8", 0.6, 32, 4, None)]
    return verify_kernel_check(torch, shapes, cases, 200)


def verify_kernel_check(torch, shapes, cases, seed):
    """paged_verify against its plain version and, query by query, against
    paged_decode on each case (label, alpha, Hq, Hkv, window) at
    ``shapes``; the first case timed alone beside its wrapper, its plain
    version and its bound."""
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    worst, physical = 0.0, None
    for i, (label, alpha, hq, hkv, window) in enumerate(cases):
        cfg = BitStopperConfig(alpha=alpha)
        args = decode_case(torch, seed + i, Hq=hq, Hkv=hkv, **shapes)
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

    _, alpha, hq, hkv, _ = cases[0]
    cfg = BitStopperConfig(alpha=alpha)
    args = decode_case(torch, seed, Hq=hq, Hkv=hkv, **shapes)
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
    print(f"[chip_smoke] paged_verify timing (B={shapes['B']}, Sq="
          f"{shapes['Sq']}, Hq={hq}, Hkv={hkv}, D={shapes['D']}, bs="
          f"{shapes['bs']}, MB={shapes['MB']}): wrapper {ms:.4f} ms, "
          f"kernel alone "
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
    return [uncached_width_check(torch, 320 + i, WIDE_N, d, dv, "wide",
                                 exact_out=True)
            for i, (d, dv) in enumerate(WIDE_WIDTHS)]


def uncached_width_check(torch, seed, N, d, dv, label, exact_out):
    """Both cache-free kernels on hot [N, 1024, d] inputs (V [N, 1024,
    dv]) against their plain versions: bitstopper_qk's rounds and
    survivors equal, causal and not, its out equal bit for bit
    (``exact_out``) or within UNCACHED_TOL, its copies as designed; flash
    causal within UNCACHED_TOL; each timed alone, causal, beside its bound
    and their plain versions (flash beside scaled_dot_product_attention).
    Returns the timings as a row."""
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import bitstopper_qk as bq
    from repro_torch.kernels import flash_attention as fa
    cfg = BitStopperConfig(alpha=0.6)
    tag = f"{label} d={d} dv={dv}"
    q, k, v = uncached_case(torch, seed, N=N, d=d, dv=dv)
    N, S, _ = q.shape
    blk = min(128, S)
    ops = bq.prep(q, k, v, cfg)
    qk_err = 0.0
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
        for field in ("rounds", "survivors") + (("out",) if exact_out
                                                 else ()):
            a, b = getattr(ker, field), getattr(ref, field)
            if not torch.equal(a, b):
                raise SystemExit(
                    f"[chip_smoke] bitstopper_qk {tag} causal={causal}: "
                    f"{field} differs in {int((a != b).sum())} entries")
        err = float((ker.out - ref.out).abs().max())
        qk_err = max(qk_err, err)
        if not err <= UNCACHED_TOL:
            raise SystemExit(f"[chip_smoke] bitstopper_qk {tag} causal="
                             f"{causal}: out differs by {err} > "
                             f"{UNCACHED_TOL}")
        n_qt, n_kb = ker.rounds.shape[1:]
        live_v = int(ker.survivors.reshape(N, n_qt, blk, n_kb, blk)
                     .any(4).any(2).sum())
        design = bq.design_plane_bytes(ker.rounds, cfg.bits, blk, d)
        if planes != design or v_bytes != live_v * blk * dv * 4:
            raise SystemExit(f"[chip_smoke] bitstopper_qk {tag} copied "
                             f"{planes} plane and {v_bytes} V bytes; the "
                             f"design copies {design} and "
                             f"{live_v * blk * dv * 4}")
    kargs, held = bq.kernel_args(ops, cfg, blk, blk, True)
    qk_ms = cuda_ms(torch, lambda: bq.launch_c(*kargs), iters=5, warmup=1)
    qk_plain_ms = cuda_ms(torch, lambda: bq.bitstopper_qk_plain(
        ops, cfg, blk, blk, True), iters=1, warmup=1)
    nbytes, plane_ops, pv_ops, live = qk_bytes_ops(ops, ker, blk, blk)
    qk_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    qk_ops_ms = (plane_ops / FP16_OPS_PER_S + pv_ops / F32_OPS_PER_S) * 1e3
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= UNCACHED_TOL:
        raise SystemExit(f"[chip_smoke] flash_attention {tag}: out differs "
                         f"by {err} > {UNCACHED_TOL}")
    fl_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True),
                    iters=5, warmup=1)
    fl_plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=True), iters=2, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True),
                     iters=5, warmup=1)
    fl_bytes = N * S * (2 * d + 2 * dv) * 4
    fl_ops = N * S * (S + 1) // 2 * 2 * (d + dv)
    # The bound of the function is the narrow row's: f32-accurate products
    # at the split-TF32 rate.  The wide form runs on the CUDA cores, whose
    # f32 bound is printed beside it.
    fl_bound = max(fl_bytes / HBM_BYTES_PER_S,
                   fl_ops / SPLIT_TF32_OPS_PER_S) * 1e3
    fl_bound_f32 = fl_ops / F32_OPS_PER_S * 1e3
    print(f"[chip_smoke] {tag} (N={N}, S={S}, causal): bitstopper_qk "
          f"rounds/survivors{'/out' if exact_out else ''} equal to plain "
          f"(max|out diff| {qk_err:.3e}), copies as designed ({planes} "
          f"plane, {v_bytes} V bytes), kernel {qk_ms:.4f} ms, plain "
          f"{qk_plain_ms:.3f} ms, bound {max(qk_bytes_ms, qk_ops_ms):.5f} ms "
          f"({live} live rounds); flash max|out diff| {err:.3e}, kernel "
          f"{fl_ms:.4f} ms, plain {fl_plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms, bound "
          f"{fl_bound:.5f} ms at the split-TF32 rate ({fl_bound_f32:.5f} ms "
          f"at the f32 CUDA-core rate)")
    return {"d": d, "dv": dv, "N": N, "S": S, "qk_ms": qk_ms,
            "qk_plain_ms": qk_plain_ms,
            "qk_bound_ms": max(qk_bytes_ms, qk_ops_ms),
            "qk_bound_by": "bytes" if qk_bytes_ms >= qk_ops_ms
            else "operations",
            "qk_max_abs_err": qk_err,
            "flash_ms": fl_ms, "flash_plain_ms": fl_plain_ms,
            "flash_bound_ms": fl_bound,
            "flash_bound_by": "bytes" if fl_bytes / HBM_BYTES_PER_S
            >= fl_ops / SPLIT_TF32_OPS_PER_S else "operations",
            "flash_bound_f32_ms": fl_bound_f32,
            "flash_library_ms": lib_ms,
            "flash_max_abs_err": err}


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
def forward_path_phase(torch, cfg, params, name="forward"):
    """transformer.forward with no caches over FWD_B prompts of FWD_S
    tokens at full width and depth, for every attention impl.  Returns the
    launches of bitstopper_qk and flash_attention in their impls' runs."""
    return cache_free_forwards(torch, cfg, params, name)


def cache_free_forwards(torch, cfg, params, name, hold_logits=True):
    """The forward at every impl; ``hold_logits=False`` holds each kernel
    impl to its plain impl's argmax at every position and reports the
    logits' gap (a MoE model: an ulp can move a token across a router
    tie)."""
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
            raise SystemExit(f"[chip_smoke] {name} {impl}: logits "
                             f"{tuple(out.shape)} not finite or caches")
        logits[impl] = out
        print(f"[chip_smoke] {name} {impl}: {dt * 1e3:.1f} ms, "
              f"{FWD_B * FWD_S / dt:.1f} prompt tokens/s; launches "
              f"bitstopper_qk {launches[impl][0]}, flash_attention "
              f"{launches[impl][1]}")
    n = cfg.n_layers
    want = {"bitstopper": (n, 0), "bitstopper_xla": (0, 0), "flash": (0, n),
            "xla": (0, 0)}
    if launches != want:
        raise SystemExit(f"[chip_smoke] {name} launches {launches}, "
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
        print(f"[chip_smoke] {name} {ker} vs {plain}: max|diff| "
              f"{diff:.3e} (max|logit| {scale:.3f}, limit {rel:g} of it); "
              f"argmax equal at {same * 100:.2f}% of positions")
        if (hold_logits and not diff <= rel * scale) or same != 1.0:
            raise SystemExit(f"[chip_smoke] {name} {ker} disagrees with "
                             f"{plain}")
    gap = float((logits["bitstopper"] - logits["xla"]).abs().max())
    agree = float((logits["bitstopper"].argmax(-1)
                   == logits["xla"].argmax(-1)).float().mean())
    print(f"[chip_smoke] {name} bitstopper vs dense xla (INT12 quantization"
          f" and pruning, reported only): max|diff| {gap:.3e}, argmax equal "
          f"at {agree * 100:.2f}% of positions")
    return launches["bitstopper"][0], launches["flash"][1]


def make_requests(np, Request, seed, n, new_tokens, vocab):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab, int(rng.integers(64, 385)),
                                        dtype=np.int32),
                    max_new_tokens=new_tokens) for _ in range(n)]


def repeated_prompts(np, vocab):
    """The speculative phase's four repeated-pattern prompts (96-192
    tokens), where the n-gram drafter finds drafts."""
    rng = np.random.default_rng(5)
    return [np.resize(rng.integers(0, vocab, 6 + 5 * i, dtype=np.int32),
                      96 + 32 * i) for i in range(4)]


def cut_model(cfg, params, depth=4):
    """The model cut to its first ``depth`` layers (full width), segment by
    segment in whole pattern units; the units past the first one that does
    not fit are left out.  Leaves outside the segments are kept."""
    segments, left = [], depth
    cut = {k: v for k, v in params.items() if not k.startswith("seg")}
    for si, (unit, reps) in enumerate(cfg.segments):
        n = min(reps, left // len(unit))
        if n == 0:
            break
        segments.append((unit, n))
        cut[f"seg{si}"] = params[f"seg{si}"][:n]
        left -= n * len(unit)
    return cfg.replace(segments=tuple(segments)), cut


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

    def _timed(self, *a, **kw):
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        self.real(*a, **kw)
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
    PagedEngine; returns the decode kernel's launch count of the main run,
    its requests (the recorded plain tokens), its mean pure decode tick
    and its tokens/s and byte reports (for the bf16 path)."""
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

    # Fused kernel vs the plain oracle on a short trace at cut depth 4 (the
    # oracle took a minute at full depth): same tokens.
    cut, cut_params = cut_model(cfg, params)
    streams = []
    for fused in (True, False):
        short = make_requests(np, Request, 1, 4, 8, cfg.vocab)
        t = time.perf_counter()
        PagedEngine(cut, cut_params, ServeConfig(
            max_slots=4, page_size=16, max_len=512,
            fused_decode=fused)).generate(short)
        torch.cuda.synchronize()
        print(f"[chip_smoke] short trace, depth {cut.n_layers}, "
              f"fused_decode={fused}: {time.perf_counter() - t:.3f} s")
        streams.append([r.generated for r in short])
    if streams[0] != streams[1]:
        raise SystemExit(f"[chip_smoke] fused and plain decode disagree: "
                         f"{streams[0]} vs {streams[1]}")
    print(f"[chip_smoke] fused and plain decode give identical tokens on "
          f"{len(streams[0])} requests")
    reports = {"tok_s": n_tok / wall,
               "decode_ms": float(np.mean(tick_ms["decode"])),
               "kv_bytes_resident": eng.kv_bytes_resident(),
               "peak_blocks": eng.pool.peak_live_blocks,
               "memory_report": eng.memory_report()}
    return launches, reqs, reports["decode_ms"], reports


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

    prompts = repeated_prompts(np, cfg.vocab)
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
def sampled_path_phase(torch, cfg, params):
    """(a) the sampler on the card against the CPU, at full width; at cut
    depth 4 (to keep the run inside its time limit): (b) the main trace
    sampled, uncontended and oversubscribed, (c) sampled speculative
    serving against (b)'s uncontended run.  Returns the decode kernel's
    launches in (b), the verify kernel's in (c)'s replay run and the
    prefill chunks of (b)'s oversubscribed run (which recomputes on
    resume; the schedule depends on the prompt lengths alone)."""
    import numpy as np
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    kernels, copies = sampler_card_vs_cpu(torch, cfg.vocab)

    cfg, params = cut_model(cfg, params)
    depth = cfg.n_layers
    full, want, l_full, tick_ms, timer = serve_sampled(
        torch, np, cfg, params, f"sampled (b) uncontended, depth {depth}")
    worst = sum(sorted(-(-(len(p) + 31) // 16) for p in
                       (r.prompt for r in full.requests.values()))[-4:])
    print(f"[chip_smoke] sampled (b): oversubscribed pool {OVERSUB_POOL_BLOCKS}"
          f" blocks (capacity {OVERSUB_POOL_BLOCKS - 1}) against {worst} for "
          f"the four largest worst-case reservations; uncontended pool "
          f"{full.layout.pool_blocks}")
    over, got, l_over, _, _ = serve_sampled(
        torch, np, cfg, params, f"sampled (b) oversubscribed, depth {depth}",
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
          f"ms at depth {depth}; sampler {per_tick:.4f} ms per call on the "
          f"served path (CUDA events), {kernels} kernels + {copies} copies "
          f"per decode tick")

    # (c) Speculative serving at TEMPERATURE against the plain sampled
    # runs: the main trace with drafts replaying (b)'s uncontended tokens,
    # and the speculative phase's repeated-pattern trace with the n-gram
    # drafter.
    reqs = [full.requests[rid] for rid in sorted(full.requests)]
    eng, got, verify_launches, _ = serve_speculative(
        torch, np, cfg, params, [r.prompt for r in reqs], 32,
        ReplayDrafter(np, reqs), f"sampled (c) replay, depth {cfg.n_layers}",
        seed=SAMPLE_SEED, speculative="draft", temperature=TEMPERATURE)
    if got != want:
        raise SystemExit("[chip_smoke] sampled (c): replay speculative "
                         "tokens differ from plain sampled")
    if eng.counters["spec_accepted"] == 0:
        raise SystemExit("[chip_smoke] sampled (c) replay accepted no draft")
    prompts = repeated_prompts(np, cfg.vocab)
    plain = [Request(prompt=p.copy(), max_new_tokens=16) for p in prompts]
    PagedEngine(cfg, params, ServeConfig(
        max_slots=4, page_size=16, max_len=512,
        temperature=TEMPERATURE)).generate(plain, SAMPLE_SEED)
    want = [r.generated for r in plain]
    _, got, _, _ = serve_speculative(
        torch, np, cfg, params, prompts, 16,
        label=f"sampled (c) ngram, depth {cfg.n_layers}", seed=SAMPLE_SEED,
        speculative="ngram", temperature=TEMPERATURE)
    if got != want:
        raise SystemExit("[chip_smoke] sampled (c): n-gram speculative "
                         "tokens differ from plain sampled")
    print("[chip_smoke] sampled (c): replay and n-gram speculative serving "
          "give the plain sampled tokens")
    return l_full + l_over, verify_launches, c["prefill_chunks"]


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
    """Chaos (a), at cut depth 4 (the plan's ticks depend on the trace's
    schedule alone): the undisturbed tokens at that depth first.  Returns
    the decode and verify kernels' launches."""
    import collections
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.serving import (FaultPlan, PagedEngine, Request,
                                     ServeConfig, serve_with_chaos)
    cfg, params = cut_model(cfg, params)
    plain_reqs = [Request(prompt=r.prompt.copy(), max_new_tokens=32)
                  for r in plain_reqs]
    PagedEngine(cfg, params, ServeConfig(
        max_slots=4, page_size=16, max_len=512)).generate(plain_reqs)
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
    print(f"[chip_smoke] chaos (a), depth {cfg.n_layers}: {n_tok} tokens in "
          f"{wall:.3f} s "
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
        "the undisturbed tokens": ([r.generated for r in out]
                                   == [r.generated for r in plain_reqs]),
        "one degradation": c["degradations"] == 1,
        "the plan fired whole": (rep["fired_by_kind"] == want_kinds
                                 and rep["unfired"] == []),
        "two restores": rep["crashes"] == rep["restores"] == 2,
        "one interrupted write": rep["snapshots_interrupted"] == 1,
        "one forced preemption": c["forced_preemptions"] == 1,
        f"decode launches {cfg.n_layers} x fused decode forwards": (
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


def store_prompts(np, vocab):
    """(b)'s trace: a ``STORE_PREFIX``-token system prompt and four tails
    of 16-80 tokens."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, vocab, STORE_PREFIX, dtype=np.int32)
    return [np.concatenate([prefix, rng.integers(
        0, vocab, int(rng.integers(16, 81)), dtype=np.int32)])
        for _ in range(4)]


def store_warm_start(torch, np, cfg, params, store_dir, max_slots, label,
                     **kw):
    """(b): a cold engine on an empty store serves the trace and flushes
    its registered blocks; a fresh engine on the store serves it again
    (``kw``: more ServeConfig fields).  Returns the cold and warm engines,
    their tokens and the records flushed."""
    from repro_torch.serving import ServeConfig
    prompts = store_prompts(np, cfg.vocab)
    scfg = ServeConfig(max_slots=max_slots, page_size=16, max_len=512,
                       pool_blocks=STORE_POOL_BLOCKS,
                       prefix_store_dir=store_dir, **kw)
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
def memory_path_phase(torch, cfg, params, recompute_chunks):
    """At cut depth 4: (a) swap-to-host on the sampled oversubscribed run
    (its schedule, and so the recompute run's prefill chunks, depends on
    the prompt lengths alone), (b) the prefix store at one slot, by
    construction, (b') at four slots, measured, (c) the host prefix tier
    spilling to disk.  Returns the decode kernel's
    launches."""
    import tempfile
    import numpy as np
    tiers = TierLog(torch)
    cut, cut_params = cut_model(cfg, params)
    _, want_sampled, launches, _, _ = serve_sampled(
        torch, np, cut, cut_params,
        f"memory (a) uncontended, depth {cut.n_layers}")
    eng, got, swap_launches, _, _ = serve_sampled(
        torch, np, cut, cut_params, f"memory (a) swap, depth {cut.n_layers}",
        probe=tiers.watch, oversubscribe=True,
        pool_blocks=OVERSUB_POOL_BLOCKS, swap_host_bytes=SWAP_HOST_BYTES)
    launches += swap_launches
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
          f"{cut.n_layers} x ticks: all hold")

    with tempfile.TemporaryDirectory() as tmp, tiers.store_patch():
        cold, cold_tok, warm, warm_tok, flushed = store_warm_start(
            torch, np, cut, cut_params, f"{tmp}/b", 1, "memory (b)")
        tiers.report(np, "memory (b)", ("record write", "record load"))
        same, planes, _ = grids_and_planes(np, cold, warm)
        cc, wc = cold.counters, warm.counters
        launches += cut.n_layers * (cc["decode_steps"] + wc["decode_steps"])
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
            torch, np, cut, cut_params, f"{tmp}/b2", 4, "memory (b')")
        tiers.report(np, "memory (b')", ("record write", "record load"))
        same, _, gap = grids_and_planes(np, cold, warm)
        launches += cut.n_layers * (cold.counters["decode_steps"]
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
    """At cut depth 4 (since the mesh path; widths kept): (c) the engine
    API loop and a snapshot shutdown with restore, whose plain run gives
    the tokens (a) and (b) are held to; (a) the main trace through the
    async door over a paged engine, (b) disaggregated behind the door (a
    one-slot prefill engine hands detached prefixes to a four-slot decode
    engine), (d) the traffic reports.  Returns the decode kernel's
    launches."""
    import numpy as np
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.runtime import SystemClock
    from repro_torch.serving import PagedEngine, ServeConfig
    from repro_torch.serving.frontdoor import DisaggController, SlaMapper

    prompts = [r.prompt for r in plain_reqs]
    new_tokens = len(plain_reqs[0].generated)
    cfg, params = cut_model(cfg, params)
    launches_c, want = frontdoor_cut_depth(torch, np, cfg, params, prompts,
                                           new_tokens)

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
        "the plain tokens at this depth": got == want,
        "admission in arrival order": (
            door.admission_log == list(range(len(prompts)))),
        "the pool drained": eng.pool.available() == eng.pool.capacity,
        f"decode launches {cfg.n_layers} x ticks": (
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
        "the plain tokens at this depth": got_b == want,
        "8 prefixes transferred": x["prefixes_transferred"] == len(prompts),
        f"{blocks} blocks transferred": x["blocks_transferred"] == blocks,
        f"{blocks} x {per_block} payload bytes": (
            x["payload_bytes"] == blocks * per_block),
        "both pools drained": (
            pre.pool.available() == pre.pool.capacity
            and dec.pool.available() == dec.pool.capacity),
        f"decode launches {cfg.n_layers} x decode-engine ticks, none by "
        "prefill": (
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
    """(c) on the model as given (the caller's cut depth): the
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
    depth = cfg.n_layers
    scfg = ServeConfig(max_slots=4, page_size=16, max_len=512)

    def reqs():
        return [Request(prompt=p.copy(), max_new_tokens=new_tokens)
                for p in prompts]

    pd.LAUNCHES = 0
    ref_eng = PagedEngine(cfg, params, scfg)
    ref = reqs()
    ref_eng.generate(ref)
    want = [r.generated for r in ref]
    launches = pd.LAUNCHES
    ok = launches == depth * ref_eng.counters["decode_steps"]

    api = PagedEngine(cfg, params, scfg)
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
        door = AsyncFrontDoor(PagedEngine(cfg, params, scfg),
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
        door2 = AsyncFrontDoor(PagedEngine(cfg, params, scfg),
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
    return launches, want


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


def serve_main_trace(torch, np, eng, vocab, label, prefill_key):
    """Serve the main trace greedily on ``eng``, every tick timed; returns
    the tokens, tokens/s and the mean pure decode, pure prefill and mixed
    tick."""
    from repro_torch.serving import Request
    reqs = make_requests(np, Request, 0, 8, 32, vocab)
    ticks = timed_ticks(torch, eng, prefill_key)
    t = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n_tok = sum(len(r.generated) for r in reqs)
    print(f"[chip_smoke] {label}: {n_tok} new tokens in {wall:.3f} s "
          f"({n_tok / wall:.2f} tok/s); {len(ticks['decode'])} pure decode "
          f"ticks at mean {mean_ms(ticks['decode']):.2f} ms, "
          f"{len(ticks['prefill'])} pure prefill ticks at mean "
          f"{mean_ms(ticks['prefill']):.2f} ms, {len(ticks['mixed'])} mixed "
          f"at mean {mean_ms(ticks['mixed']):.2f} ms; counters "
          f"{eng.counters}")
    return dict(tokens=[r.generated for r in reqs], tok_s=n_tok / wall,
                decode_ms=mean_ms(ticks["decode"]),
                prefill_ms=mean_ms(ticks["prefill"]),
                mixed_ms=mean_ms(ticks["mixed"]))


def near_tie_divergence(label, tap, a_toks, b_toks):
    """Run (b)'s tokens against run (a)'s: each request must equal (a)'s
    or first differ where (a)'s logits (``tap``) are a near-tie, a gap of
    at most 1e-3 of max |logit|.  Returns the divergences."""
    diverged = []
    for rid, (ta, tb) in enumerate(zip(a_toks, b_toks)):
        if ta == tb:
            continue
        pos = next(i for i, (x, y) in enumerate(zip(ta, tb)) if x != y)
        gap, amax = tap.gap(rid, pos, ta[pos], tb[pos])
        print(f"[chip_smoke] {label} request {rid}: first differs at token "
              f"{pos} ({ta[pos]} vs {tb[pos]}); the first run's logit gap "
              f"{gap:.6e}, max |logit| {amax:.6e}, ratio {gap / amax:.3e}")
        if not gap <= 1e-3 * amax:
            raise SystemExit(f"[chip_smoke] {label}: request {rid} leaves "
                             f"the first run's tokens at {pos} where its "
                             f"logits are no near-tie")
        diverged.append((rid, pos, gap, amax))
    return diverged


@phase("dense path")
def dense_path_phase(torch, cfg, params):
    """The dense serving slice at full width and cut depth 4 (the caller
    cuts it), on the main trace:
    (a) the paged engine on ``attn_impl="xla"``; (b) the contiguous engine
    on ``xla``, whose tokens must equal (a)'s or first differ where (a)'s
    logits are a near-tie; (c) the contiguous engine on
    ``bitstopper_xla``; (d) the static engine on
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
        out[label] = serve_main_trace(torch, np, eng, cfg.vocab,
                                      f"dense {label}", prefill_key)

    # (a) paged on xla: a pure prefill tick is one 64-token chunk.
    paged = PagedEngine(dense, params, scfg)
    tap = LogitTap(torch, paged)
    serve("(a) paged xla", paged, "prefill_chunks")
    # (b) contiguous on xla: a tick that admits prefills whole prompts,
    # then decodes (mixed).
    contiguous = ContinuousBatchingEngine(dense, params, scfg)
    serve("(b) contiguous xla", contiguous, "prefill_tokens")
    diverged = near_tie_divergence(
        "dense (b) vs (a)", tap, out["(a) paged xla"]["tokens"],
        out["(b) contiguous xla"]["tokens"])
    print(f"[chip_smoke] dense (b) vs (a): {8 - len(diverged)} of 8 "
          f"requests equal token for token"
          + (f"; the others first differ at near-ties {diverged}"
             if diverged else ""))
    # (c) contiguous on bitstopper_xla.
    serve("(c) contiguous bitstopper_xla",
          ContinuousBatchingEngine(cfg, params, scfg), "prefill_tokens")
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

# ---------------------------------------------------------------------------
# bf16 KV caches (ServeConfig.cache_dtype="bfloat16")
# ---------------------------------------------------------------------------


@phase("bf16 kernels")
def bf16_kernel_phase(torch):
    """(a) The decode and verify kernels' bf16-V forms at the kernel phases'
    shape (bs=16) and on the striped walk (bs=512), against their plain
    versions on the same bf16 pools: rounds, survivors and v_fetched equal,
    out within OUT_TOL and bit for bit the f32 form's on the widened pool,
    every real verify query equal to the bf16 decode at its position, the
    V bytes each requested equal to the design's (2-byte values) and half
    the f32 form's.  Each timed alone beside the f32 form on the widened
    pool and its bound.  Returns {kernel name: [a row per page size]}."""
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    cfg = BitStopperConfig(alpha=0.6)
    rows = {"paged_decode": [], "paged_verify": []}
    for bs, MB, P in ((16, 32, 129), LARGE_PAGES[0]):
        shapes = dict(B=4, Hq=32, Hkv=32, D=64, bs=bs, MB=MB, P=P)
        for name, mod, Sq, seed in (("paged_decode", pd, 1, 100),
                                    ("paged_verify", pv, SPEC_K + 1, 200)):
            f32 = decode_case(torch, seed, Sq=Sq, **shapes)
            args = f32[:2] + (f32[2].to(torch.bfloat16),) + f32[3:]
            wide = args[:2] + (args[2].float(),) + args[3:]
            kern, plain = ((pd.paged_bitstopper_decode,
                            pd.paged_bitstopper_decode_plain) if Sq == 1 else
                           (pv.paged_bitstopper_verify,
                            pv.paged_bitstopper_verify_plain))
            label = f"{name} bf16 V, bs={bs}"
            mod.copied_bytes()
            mod.launch_kernel(*wide, cfg=cfg)
            _, v32 = mod.copied_bytes()
            _, rounds_h, surv = mod.launch_kernel(*args, cfg=cfg)
            planes, v16 = mod.copied_bytes()
            ker, ref = kern(*args, cfg=cfg), plain(*args, cfg=cfg)
            ker32 = kern(*wide, cfg=cfg)
            torch.cuda.synchronize()
            for field in ("rounds", "survivors", "v_fetched"):
                a, b = getattr(ker, field), getattr(ref, field)
                if not torch.equal(a, b):
                    raise SystemExit(f"[chip_smoke] {label}: {field} "
                                     f"differs in {int((a != b).sum())} "
                                     f"entries")
            err = float((ker.out - ref.out).abs().max())
            if not err <= OUT_TOL or not torch.equal(ker.out, ker32.out):
                raise SystemExit(f"[chip_smoke] {label}: out differs from "
                                 f"plain by {err} (tolerance {OUT_TOL}) or "
                                 f"from the f32 form on the widened pool")
            if Sq == 1:
                B, Hq = args[0].shape[:2]
                live_v = int(surv.reshape(B, 32, Hq // 32, MB, bs)
                             .any(4).any(2).sum())
                design = (decode_plane_bytes(args, rounds_h, None)[1],
                          live_v * bs * args[2].shape[-1] * 2)
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
                                f"[chip_smoke] {label}: query {s} {field} "
                                f"differs from the bf16 decode at its "
                                f"position")
            if (planes, v16) != design or 2 * v16 != v32:
                raise SystemExit(f"[chip_smoke] {label}: copied {planes} "
                                 f"plane and {v16} V bytes; the design "
                                 f"copies {design}, the f32 form {v32} V "
                                 f"bytes")
            iters = 50 if bs == 16 else 20
            kargs, *held = mod.kernel_args(*args, cfg=cfg, stats=False)
            kernel_ms = cuda_ms(torch, lambda: mod.launch_c(
                *kargs, v_dtype=torch.bfloat16), iters=iters, warmup=5)
            wargs, *held32 = mod.kernel_args(*wide, cfg=cfg, stats=False)
            f32_ms = cuda_ms(torch, lambda: mod.launch_c(*wargs),
                             iters=iters, warmup=5)
            plain_ms = cuda_ms(torch, lambda: plain(*args, cfg=cfg,
                                                    stats=False),
                               iters=3 if bs == 16 else 1, warmup=1)
            bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ops = ops / INT8_OPS_PER_S * 1e3
            print(f"[chip_smoke] {label} (B=4, Sq={Sq}, H=32, D=64, "
                  f"MB={MB}): rounds/survivors/v_fetched equal to plain; "
                  f"max|out diff| {err:.3e}, out bit-equal to the f32 form "
                  f"on the widened pool; copied {planes} plane and {v16} V "
                  f"bytes (measured, as designed; the f32 form {v32}); "
                  f"kernel alone {kernel_ms:.4f} ms (f32 form "
                  f"{f32_ms:.4f}), plain {plain_ms:.3f} ms, bound "
                  f"{max(bound_bytes, bound_ops):.5f} ms ({nbytes} bytes, "
                  f"{ops} ops)"
                  + ("; every real query equal to the bf16 decode"
                     if Sq > 1 else ""))
            rows[name].append({
                "bs": bs, "ms": kernel_ms, "f32_ms": f32_ms,
                "plain_ms": plain_ms,
                "bound_ms": max(bound_bytes, bound_ops),
                "bound_by": ("bytes" if bound_bytes >= bound_ops
                             else "operations"),
                "max_abs_err": err, "v_bytes": v16, "f32_v_bytes": v32})
    return rows


@phase("bf16 path")
def bf16_path_phase(torch, cfg, params, f32_main):
    """(b) the main trace at full width, cut depth 4, on a bf16 cache, (c)
    at cut depth 4 the kernel against the plain oracle, replayed speculation,
    a sampled oversubscribed run with a swap tier and a prefix store cold
    then warm, all at bf16, (d) the dense engines at bf16.  Returns the
    decode and verify kernels' launches."""
    import numpy as np
    decode = bf16_main_trace(torch, np, cfg, params, f32_main)
    more, verify = bf16_cut_depth(torch, np, cfg, params)
    bf16_dense(torch, np, cfg, params)
    return decode + more, verify


def bf16_main_trace(torch, np, cfg, params, f32_main):
    """(b): PagedEngine on bitstopper_xla with the decode kernel and a bf16
    cache, at cut depth 4: one decode launch per layer per decode tick,
    tokens/s and the decode tick, the byte reports against the f32 main
    path's at full depth (the same schedule: equal peak blocks; per layer
    the K/V bytes halved).  Returns the decode launches."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serving import PagedEngine, ServeConfig
    n_full = cfg.n_layers
    cfg, params = cut_model(cfg, params)
    eng = PagedEngine(cfg, params, ServeConfig(
        max_slots=4, page_size=16, max_len=512, cache_dtype=BF16))
    layer = eng.caches["seg0"][0]["b0"]
    if not eng.cfg.fused_decode or layer["v"].dtype != torch.bfloat16:
        raise SystemExit("[chip_smoke] bf16 (b): the engine did not resolve "
                         "to the kernel over a bf16 pool")
    with LaunchTimer(torch, pd) as timer:
        pd.LAUNCHES = 0
        run = serve_main_trace(torch, np, eng, cfg.vocab,
                               "bf16 (b) main trace", "prefill_chunks")
        launches = pd.LAUNCHES
    steps = eng.counters["decode_steps"]
    if launches != cfg.n_layers * steps or not steps:
        raise SystemExit(f"[chip_smoke] bf16 (b): {launches} decode "
                         f"launches for {steps} ticks x {cfg.n_layers} "
                         f"layers")
    for toks in run["tokens"]:
        if len(toks) != 32 or not all(0 <= x < cfg.vocab for x in toks):
            raise SystemExit(f"[chip_smoke] bf16 (b): generated {toks}")
    kv16 = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    peak = eng.kv_bytes_resident()
    # Every layer holds the same bytes: the f32 main path's at this depth.
    f32_peak = f32_main["kv_bytes_resident"] // n_full * cfg.n_layers
    want = f32_peak - f32_main["peak_blocks"] * eng.scfg.page_size * kv16
    rep = eng.memory_report()
    print(f"[chip_smoke] bf16 (b) at depth {cfg.n_layers}: {run['tok_s']:.2f}"
          f" tok/s and pure decode ticks of {run['decode_ms']:.2f} ms; "
          f"paged_decode launches {launches} = {cfg.n_layers} x {steps} "
          f"ticks ({timer.ms() / max(launches, 1):.4f} ms per launch, CUDA "
          f"events)")
    ratio = peak / f32_peak
    print(f"[chip_smoke] bf16 (b): kv_bytes_resident() {peak} against "
          f"{f32_peak} at f32 and this depth ({ratio:.4f}); {kv16} K/V "
          f"bytes a token instead of {2 * kv16}; memory_report() {rep}")
    if (eng.pool.peak_live_blocks != f32_main["peak_blocks"]
            or peak != want):
        raise SystemExit(f"[chip_smoke] bf16 (b): peak blocks "
                         f"{eng.pool.peak_live_blocks} (f32 "
                         f"{f32_main['peak_blocks']}), kv_bytes_resident "
                         f"{peak}, want {want}")
    return launches


def bf16_cut_depth(torch, np, cfg, params):
    """(c) at cut depth 4, bf16 caches: the main trace with the kernel, a
    short trace with the kernel and with the plain oracle (equal tokens),
    the main trace served again speculatively with drafts replaying the
    kernel run's tokens (equal tokens), the sampled oversubscribed run with
    a swap tier (the uncontended sampled tokens), and a prefix store cold
    then warm at one slot (equal tokens, scales and planes).  Returns the
    decode and verify launches."""
    import tempfile
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    cut, cut_params = cut_model(cfg, params)
    depth = cut.n_layers
    streams, launches = {}, 0
    # The plain oracle serves the short trace only: on the main trace it
    # took a minute of the run's time limit.
    for label, fused, seed, n, new in (("main", True, 0, 8, 32),
                                       ("short", True, 1, 4, 8),
                                       ("short", False, 1, 4, 8)):
        eng = PagedEngine(cut, cut_params, ServeConfig(
            max_slots=4, page_size=16, max_len=512, cache_dtype=BF16,
            fused_decode=fused))
        reqs = make_requests(np, Request, seed, n, new, cfg.vocab)
        pd.LAUNCHES = 0
        t = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        steps = eng.counters["decode_steps"]
        if pd.LAUNCHES != (depth * steps if fused else 0) or not steps:
            raise SystemExit(f"[chip_smoke] bf16 (c) fused={fused}: "
                             f"{pd.LAUNCHES} decode launches for {steps} "
                             f"ticks x {depth} layers")
        launches += pd.LAUNCHES
        streams[label, fused] = reqs
        print(f"[chip_smoke] bf16 (c) depth {depth}, fused_decode={fused}: "
              f"the {label} trace ({n} requests) in {wall:.3f} s, {steps} "
              f"decode ticks, {pd.LAUNCHES} decode launches")
    if [r.generated for r in streams["short", True]] != \
            [r.generated for r in streams["short", False]]:
        raise SystemExit("[chip_smoke] bf16 (c): the kernel and the plain "
                         "oracle disagree")
    main = streams["main", True]
    want = [r.generated for r in main]
    eng, got, verify, verify_ticks = serve_speculative(
        torch, np, cut, cut_params, [r.prompt for r in main], 32,
        ReplayDrafter(np, main),
        f"bf16 (c) speculative replay, depth {depth}", speculative="draft",
        cache_dtype=BF16)
    launches += pd.LAUNCHES            # the speculative run's decodes
    if got != want or not verify_ticks:
        raise SystemExit(f"[chip_smoke] bf16 (c): speculative tokens "
                         f"{'differ' if got != want else 'equal'}, "
                         f"{len(verify_ticks)} verify ticks")

    _, want_s, l1, _, _ = serve_sampled(
        torch, np, cut, cut_params, f"bf16 (c) sampled, depth {depth}",
        cache_dtype=BF16)
    eng, got, l2, _, _ = serve_sampled(
        torch, np, cut, cut_params, f"bf16 (c) sampled swap, depth {depth}",
        oversubscribe=True, pool_blocks=OVERSUB_POOL_BLOCKS,
        swap_host_bytes=SWAP_HOST_BYTES, cache_dtype=BF16)
    launches += l1 + l2
    c, rep = eng.counters, eng.memory_report()
    checks = {
        "the uncontended sampled tokens": got == want_s,
        "a preemption swapped out and in": (
            c["preemptions"] >= 1 and c["swap_outs"] >= 1
            and c["swap_ins"] >= 1),
        "the swap pool empty": rep["host_swap_bytes"] == 0 < rep[
            "host_swap_bytes_peak"],
        "the pool drained": eng.pool.available() == eng.pool.capacity,
    }
    with tempfile.TemporaryDirectory() as tmp:
        cold, cold_tok, warm, warm_tok, flushed = store_warm_start(
            torch, np, cut, cut_params, f"{tmp}/store", 1,
            f"bf16 (c) store, depth {depth}", cache_dtype=BF16)
        same, planes, _ = grids_and_planes(np, cold, warm)
        checks.update({
            "the cold store tokens when warm": warm_tok == cold_tok,
            "every scale and plane byte equal warm": same and planes,
            "at least 16 store hits": (
                flushed >= 16 and warm.counters["prefix_store_hits"] >= 16),
        })
        launches += depth * (cold.counters["decode_steps"]
                             + warm.counters["decode_steps"])
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"[chip_smoke] bf16 (c) failed: {failed}")
    print(f"[chip_smoke] bf16 (c): swap {c['swap_outs']} out, "
          f"{c['swap_ins']} in, memory_report() {rep}; store "
          f"{flushed} records, {warm.counters['prefix_store_hits']} hits "
          f"warm; the kernel's and the oracle's tokens, the replayed "
          f"drafts' tokens ({verify} verify launches), "
          f"{', '.join(checks)}: all hold")
    return launches, verify


def bf16_dense(torch, np, cfg, params):
    """(d) the dense engines on a bf16 cache at full width and depth:
    ContinuousBatchingEngine on xla gives PagedEngine on xla's tokens, or
    first differs where the paged run's logits are a near-tie; the
    contiguous cache's resident bytes are half the f32 cache's.  No kernel
    of the port launches."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.serving import (ContinuousBatchingEngine, PagedEngine,
                                     ServeConfig)
    pd.LAUNCHES = pv.LAUNCHES = 0
    dense = cfg.replace(attn_impl="xla")
    scfg = ServeConfig(max_slots=4, page_size=16, max_len=512,
                       cache_dtype=BF16)
    paged = PagedEngine(dense, params, scfg)
    tap = LogitTap(torch, paged)
    a = serve_main_trace(torch, np, paged, cfg.vocab, "bf16 (d) paged xla",
                         "prefill_chunks")
    contiguous = ContinuousBatchingEngine(dense, params, scfg)
    b = serve_main_trace(torch, np, contiguous, cfg.vocab,
                         "bf16 (d) contiguous xla", "prefill_tokens")
    diverged = near_tie_divergence("bf16 (d) contiguous vs paged", tap,
                                   a["tokens"], b["tokens"])
    want = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2 * 512 * 4
    got = contiguous.kv_bytes_resident()
    print(f"[chip_smoke] bf16 (d): {8 - len(diverged)} of 8 requests equal "
          f"token for token"
          + (f", the others first differ at near-ties {diverged}"
             if diverged else "")
          + f"; contiguous kv_bytes_resident {got}, paged peak "
          f"{paged.kv_bytes_resident()}")
    if got != want or pd.LAUNCHES or pv.LAUNCHES:
        raise SystemExit(f"[chip_smoke] bf16 (d): contiguous bytes {got} "
                         f"(want {want}), kernel launches {pd.LAUNCHES}, "
                         f"{pv.LAUNCHES}")


# ---------------------------------------------------------------------------
# the model zoo: MoE serving of qwen2-moe-a2.7b, then MLA, Mamba-2, RG-LRU
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"


@phase("moe kernels")
def moe_kernel_phase(torch):
    """The decode and verify kernels at a qwen2-moe-a2.7b attention layer's
    shape (B=4, Hq=Hkv=16, D=128, pages of 16, alpha 0.6), as the kernel
    phases hold them at D=64: integers equal to plain, out within OUT_TOL,
    every verify query equal to the decode at its position, bytes as
    designed, each timed alone beside its bound.  Then the cache-free
    kernels at one layer of the MoE forward (2 prompts x 16 heads of 128,
    S=1024): bitstopper_qk's rounds and survivors equal to plain, causal
    and not, its out and flash's within UNCACHED_TOL, each timed beside its
    bound.  Returns the rows of the four kernels at these shapes."""
    keep = ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "physical_bytes")
    dec = decode_kernel_check(torch, MOE_SHAPES, MOE_DECODE_CASES, 300)
    shapes = dict(MOE_SHAPES, Sq=SPEC_K + 1)
    del shapes["Hq"]
    ver = verify_kernel_check(torch, shapes, MOE_VERIFY_CASES, 310)
    shape = {"B": 4, "Hq": 16, "Hkv": 16, "D": 128, "bs": 16}
    fwd = uncached_width_check(torch, 330, FWD_B * 16, 128, 128, "moe",
                               exact_out=False)
    qk = {k[3:]: v for k, v in fwd.items() if k.startswith("qk_")}
    flash = {k[6:]: v for k, v in fwd.items() if k.startswith("flash_")}
    cut = {"N": fwd["N"], "S": fwd["S"], "D": 128}
    return ({k: dec[k] for k in keep} | shape,
            {k: ver[k] for k in keep} | shape | {"Sq": SPEC_K + 1},
            qk | {"library_ms": None} | cut,
            flash | cut)


def build_moe_model(torch):
    """Full-width, full-depth qwen2-moe-a2.7b (f32, as its registry entry
    says) with seeded random weights drawn on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.models import transformer as T
    cfg = get_config(MOE_ARCH, attn_impl="bitstopper_xla",
                     bitstopper=BitStopperConfig(alpha=0.6))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_model(cfg, gen, "cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(p.numel() for p in leaves)
    experts = sum(p.numel() for u in params["seg0"]
                  for k, p in u["b0"]["moe"].items() if k != "shared"
                  and k != "router")
    print(f"[chip_smoke] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, {cfg.n_routed} routed experts (top {cfg.top_k}, "
          f"d_expert {cfg.d_expert}) and {cfg.n_shared} shared (d_shared "
          f"{cfg.d_shared}), vocab {cfg.vocab}; {n_params} f32 parameters "
          f"({n_params * 4 / 1e9:.2f} GB; routed experts {experts * 4 / 1e9:.2f}"
          f" GB), seeded init {time.perf_counter() - t0:.2f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB")
    return cfg, params


class DropCounter:
    """Counts the dropped (token, expert) pairs and the routed rows of
    every MoE dispatch on the card, into device tensors (no host sync per
    layer), apart for verify forwards and all other calls; ``take()``
    reads and resets the counts: {"verify" | "other": (dropped, rows)}.
    Under a mesh a rank counts the pairs of its own experts that dropped
    (another rank's pairs are not its to drop)."""

    def __init__(self, torch):
        from repro_torch.models import moe
        from repro_torch.serving import PagedEngine
        self.torch, self.moe, self.engine = torch, moe, PagedEngine
        self.real_plan = moe.dispatch_plan
        self.real_verify = PagedEngine._verify_forward
        self.tag, self.counts = "other", {}

    def _plan(self, top_i, n_local, capacity, expert_offset=0):
        plan = self.real_plan(top_i, n_local, capacity, expert_offset)
        local = top_i.reshape(-1).long() - expert_offset
        mine = ((local >= 0) & (local < n_local))[plan[0]]
        c = self.counts.setdefault(self.tag, self.torch.zeros(
            2, dtype=self.torch.int64, device="cuda"))
        c[0] += (mine & ~plan[3]).sum()
        c[1] += plan[3].numel()
        return plan

    def __enter__(self):
        counter = self

        def verify(eng, *a):
            counter.tag = "verify"
            try:
                return counter.real_verify(eng, *a)
            finally:
                counter.tag = "other"

        self.moe.dispatch_plan = self._plan
        self.engine._verify_forward = verify
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_plan = self.real_plan
        self.engine._verify_forward = self.real_verify

    def take(self):
        out = {tag: tuple(int(x) for x in c)
               for tag, c in self.counts.items()}
        self.counts = {}
        return out


@phase("moe path")
def moe_path_phase(torch, cfg, params):
    """Full-width, full-depth qwen2-moe-a2.7b: (a) the main trace through
    PagedEngine on bitstopper_xla with the decode kernel (one launch per
    layer per decode tick), tokens/s, the decode tick and the prefill
    chunk, dropped (token, expert) pairs per chunk and per tick; (b) at cut
    depth 4, the kernel against the plain oracle (equal tokens) and
    replayed speculation (the plain tokens, one verify launch per layer per
    verify forward); (c) the cache-free forward of 2 x 1024 tokens at every
    impl (one kernel launch per layer, the plain impl's argmax at every
    position).  Returns the decode and verify launches of (a)-(b) and the
    forward's kernel launches."""
    import numpy as np
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    scfg = ServeConfig(max_slots=4, page_size=16, max_len=512)
    PagedEngine(cfg, params, scfg).generate(
        make_requests(np, Request, 99, 1, 2, cfg.vocab))
    torch.cuda.synchronize()

    eng = PagedEngine(cfg, params, scfg)
    if not eng.cfg.fused_decode:
        raise SystemExit("[chip_smoke] moe (a): fused_decode did not "
                         "resolve to the kernel on the card")
    ticks = {"prefill": [], "decode": [], "mixed": []}
    drops = {"prefill": [], "decode": [], "mixed": []}
    real = eng.step

    with DropCounter(torch) as counter:
        def step():
            p, d = eng.counters["prefill_chunks"], \
                eng.counters["decode_steps"]
            t = time.perf_counter()
            out = real()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t) * 1e3
            pre = eng.counters["prefill_chunks"] > p
            dec = eng.counters["decode_steps"] > d
            kind = "mixed" if pre and dec else "prefill" if pre else \
                "decode" if dec else None
            dropped = counter.take().get("other", (0, 0))
            if kind:
                ticks[kind].append(dt)
                drops[kind].append(dropped)
            return out

        eng.step = step
        reqs = make_requests(np, Request, 0, 8, 32, cfg.vocab)
        torch.cuda.reset_peak_memory_stats()
        with LaunchTimer(torch, pd) as timer:
            pd.LAUNCHES = 0
            t = time.perf_counter()
            eng.generate(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = pd.LAUNCHES
    steps = eng.counters["decode_steps"]
    n_tok = sum(len(r.generated) for r in reqs)
    print(f"[chip_smoke] moe (a) main trace: {len(reqs)} requests, prompts "
          f"{[len(r.prompt) for r in reqs]}, {n_tok} new tokens in "
          f"{wall:.3f} s ({n_tok / wall:.2f} tok/s); {steps} decode ticks, "
          f"{eng.counters['prefill_chunks']} prefill chunks; pure decode "
          f"ticks {len(ticks['decode'])} at mean "
          f"{mean_ms(ticks['decode']):.2f} ms, pure prefill ticks "
          f"{len(ticks['prefill'])} at mean {mean_ms(ticks['prefill']):.2f} "
          f"ms, mixed {len(ticks['mixed'])} at mean "
          f"{mean_ms(ticks['mixed']):.2f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for kind in ("prefill", "decode", "mixed"):
        d = np.array(drops[kind] or [(0, 0)])
        print(f"[chip_smoke] moe (a) dropped (token, expert) pairs per "
              f"{kind} tick: mean {d[:, 0].mean():.2f}, max {d[:, 0].max()},"
              f" total {d[:, 0].sum()} of {d[:, 1].sum()} routed rows "
              f"({len(drops[kind])} ticks, {cfg.n_layers} layers each)")
    print(f"[chip_smoke] moe (a): paged_decode launches {launches} = "
          f"{cfg.n_layers} x {steps} ticks ({timer.ms() / max(launches, 1):.4f}"
          f" ms per launch, CUDA events); counters {eng.counters}")
    if launches != cfg.n_layers * steps or steps == 0:
        raise SystemExit(f"[chip_smoke] moe (a): {launches} decode launches "
                         f"for {steps} ticks x {cfg.n_layers} layers")
    for r in reqs:
        if len(r.generated) != 32 or not all(0 <= x < cfg.vocab
                                             for x in r.generated):
            raise SystemExit(f"[chip_smoke] moe (a): request {r.rid} "
                             f"generated {r.generated}")

    # The device's busy share over steady decode ticks (torch.profiler).
    from torch.profiler import ProfilerActivity, profile
    prof = PagedEngine(cfg, params, scfg)
    for r in make_requests(np, Request, 0, 4, 16, cfg.vocab):
        prof.submit(r)
    while prof._prefill_fifo or not prof.counters["decode_steps"]:
        prof.step()
    report_profile(torch, ProfilerActivity, profile, "moe decode tick",
                   prof.step, 4)
    del prof

    # (b) at cut depth 4: kernel vs plain oracle, then replayed drafts.
    cut, cut_params = cut_model(cfg, params)
    streams = []
    for fused in (True, False):
        short = make_requests(np, Request, 1, 4, 8, cfg.vocab)
        pd.LAUNCHES = 0
        t = time.perf_counter()
        e = PagedEngine(cut, cut_params, ServeConfig(
            max_slots=4, page_size=16, max_len=512, fused_decode=fused))
        e.generate(short)
        torch.cuda.synchronize()
        want = cut.n_layers * e.counters["decode_steps"] if fused else 0
        if pd.LAUNCHES != want:
            raise SystemExit(f"[chip_smoke] moe (b) fused={fused}: "
                             f"{pd.LAUNCHES} decode launches, want {want}")
        launches += pd.LAUNCHES
        print(f"[chip_smoke] moe (b) cut depth {cut.n_layers}, fused_decode"
              f"={fused}: {time.perf_counter() - t:.3f} s, "
              f"{pd.LAUNCHES} decode launches")
        streams.append(short)
    if [r.generated for r in streams[0]] != [r.generated for r in
                                             streams[1]]:
        raise SystemExit(f"[chip_smoke] moe (b): kernel and plain oracle "
                         f"disagree: {[r.generated for r in streams[0]]} vs "
                         f"{[r.generated for r in streams[1]]}")
    # Replayed drafts at the config's capacity factor, then at one no call
    # can bind (n_routed / top_k: every expert holds all of a call's
    # tokens).  A verify forward routes B x (k+1) tokens with that call's
    # capacity, so it can drop pairs that a decode of the same tokens keeps
    # (pad rows of idle slots take slots too): then its tokens differ from
    # plain decoding's, as the reference's do (ROADMAP C9).
    verify_launches = 0
    for factor in (cut.moe_capacity_factor, cut.n_routed / cut.top_k):
        c = cut.replace(moe_capacity_factor=factor)
        plain = make_requests(np, Request, 1, 4, 8, cfg.vocab)
        PagedEngine(c, cut_params, ServeConfig(
            max_slots=4, page_size=16, max_len=512)).generate(plain)
        with DropCounter(torch) as counter:
            spec, got, n, _ = serve_speculative(
                torch, np, c, cut_params, [r.prompt for r in plain], 8,
                ReplayDrafter(np, plain), f"moe (b) replay, depth "
                f"{cut.n_layers}, capacity factor {factor:g}",
                speculative="draft")
            dropped = counter.take()
        verify_launches += n
        want = [r.generated for r in plain]
        v_drop, v_rows = dropped.get("verify", (0, 0))
        print(f"[chip_smoke] moe (b) capacity factor {factor:g}: replayed "
              f"speculation {'gives' if got == want else 'does not give'} "
              f"the plain tokens; verify forwards dropped {v_drop} of "
              f"{v_rows} routed rows, other calls {dropped.get('other')}")
        if spec.counters["spec_accepted"] == 0:
            raise SystemExit("[chip_smoke] moe (b): no draft accepted")
        if got != want and (factor != cut.moe_capacity_factor
                            or v_drop == 0):
            raise SystemExit(f"[chip_smoke] moe (b) capacity factor "
                             f"{factor:g}: speculative tokens {got} differ "
                             f"from plain {want} with {v_drop} verify drops")
    print(f"[chip_smoke] moe (b): kernel and plain oracle give identical "
          f"tokens on {len(streams[0])} requests; replayed speculation gives "
          f"the plain tokens wherever no verify forward drops a pair")
    del eng, spec, e

    # (c) the cache-free forward at every impl.
    qk, flash = cache_free_forwards(torch, cfg, params, "moe forward",
                                    hold_logits=False)
    return launches, verify_launches, qk, flash


MOE_MESH_VARIANTS = ("ep", "resident")   # 60 experts over 2 and over 4


def expert_leaves(params):
    """Every MoE block's routed-expert weights of a parameter tree."""
    return [u["b0"]["moe"][k] for u in params["seg0"]
            for k in ("wi_gate", "wi_up", "wo")]


def moe_mesh_rank(mesh, device, cfg, params, prompts, digest, xs):
    """A rank of the MoE mesh phase: the greedy trace served by the cut
    qwen2-moe-a2.7b on this rank under each branch, counting the pairs its
    experts dropped, its decode launches and its combine's gathers; and
    the first layer's MoE FFN on the inputs ``xs`` (its ``out``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models import moe
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"coord": tuple(mesh.get_coordinate()),
           "weights_equal": params_digest(torch, params) == digest,
           "variants": {}}
    full = expert_leaves(params)
    real_gather = moe.gather_owned
    for variant in MOE_MESH_VARIANTS:
        c = cfg.replace(moe_resident=variant == "resident")
        scfg = ServeConfig(max_slots=4, page_size=16, max_len=512, mesh=mesh)
        PagedEngine(c, params, scfg, device=device).generate(
            [Request(prompt=prompts[0][:16].copy(), max_new_tokens=2)])
        eng = PagedEngine(c, params, scfg, device=device)
        mine = expert_leaves(eng.params)
        gathers = []

        def timed(*a, **kw):
            t = time.perf_counter()
            res = real_gather(*a, **kw)
            gathers.append((time.perf_counter() - t) * 1e3)
            return res

        reqs = [Request(prompt=p.copy(), max_new_tokens=MESH_NEW_TOKENS)
                for p in prompts]
        moe.gather_owned = timed
        try:
            with DropCounter(torch) as counter:
                pd.LAUNCHES = 0
                t = time.perf_counter()
                eng.generate(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                dropped = counter.take()
        finally:
            moe.gather_owned = real_gather
        res = {
            "tokens": [list(r.generated) for r in reqs],
            "counters": dict(eng.counters), "launches": pd.LAUNCHES,
            "dropped": dropped.get("other", (0, 0))[0], "wall": wall,
            "gather_ms": gathers,
            "expert_bytes": sum(t.numel() * t.element_size() for t in mine),
            "views": all(m.untyped_storage().data_ptr()
                         == f.untyped_storage().data_ptr()
                         for m, f in zip(mine, full)),
            "local_kv_heads": int(eng.caches["seg0"][0]["b0"]["kq"]
                                  .shape[3])}
        res["spec"] = moe_replay(torch, np, c, params, prompts, reqs, mesh,
                                 device)
        with torch.no_grad():
            p0 = eng.params["seg0"][0]["b0"]["moe"]
            res["ffn"] = {k: moe.moe_ffn(p0, x, c.moe_config(),
                                         mesh=mesh)[0].cpu()
                          for k, x in xs.items()}
        out["variants"][variant] = res
    return out


def moe_replay(torch, np, cfg, params, prompts, plain, mesh=None,
               device=None):
    """The prompts served speculatively, drafts replaying ``plain``'s
    tokens: tokens, counters and both kernels' launches."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    eng = PagedEngine(cfg, params, ServeConfig(
        max_slots=4, page_size=16, max_len=512, mesh=mesh,
        speculative="draft", draft_k=SPEC_K), device=device,
        drafter=ReplayDrafter(np, plain))
    reqs = [Request(prompt=p.copy(), max_new_tokens=MESH_NEW_TOKENS)
            for p in prompts]
    pd.LAUNCHES = pv.LAUNCHES = 0
    eng.generate(reqs)
    torch.cuda.synchronize()
    return {"tokens": [list(r.generated) for r in reqs],
            "counters": dict(eng.counters), "decode": pd.LAUNCHES,
            "verify": pv.LAUNCHES}


@phase("moe mesh")
def moe_mesh_phase(torch, cfg, params):
    """qwen2-moe-a2.7b at full width, cut to depth 4 (its weights shared
    with four ranks by CUDA IPC), on a 2x2 (data, model) mesh of ranks
    sharing the card over gloo: the main trace's four shortest prompts, 8
    new tokens, 4 slots, capacity factor 1.25, under the expert-parallel
    branch (30 experts a rank) and the resident one (15).  Every rank must
    give the single-device tokens, its experts' dropped pairs must sum
    over the ranks that split the experts to one device's, it must launch
    the decode kernel 4 x its decode ticks, hold 8 of 16 KV heads and
    views of its experts' block only, and give the first layer's MoE FFN
    out of one device bit for bit at a decode tick's and a prefill chunk's
    shape.  Then the same prompts with drafts
    replaying the plain tokens: one device's speculative tokens and
    counters on every rank (C9: a verify may drop pairs that decoding
    keeps, on one device as on the mesh), the verify kernel launched 4 x
    its verify ticks.  Returns one rank's (decode, verify) launches."""
    import numpy as np
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.launch.mesh import start_mesh
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    t0 = time.perf_counter()
    cut, cut_params = cut_model(cfg, params, MESH_DEPTH)
    leaves = list(_leaves(cut_params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    experts = sum(t.numel() * t.element_size()
                  for t in expert_leaves(cut_params))
    prompts = sorted((r.prompt for r in make_requests(
        np, Request, 0, 8, 32, cfg.vocab)), key=len)[:4]
    digest = params_digest(torch, cut_params)
    # The first layer's MoE FFN at a decode tick's shape and a prefill
    # chunk's: each rank's out must be one device's, bit for bit.
    g = torch.Generator(device="cuda").manual_seed(5)
    xs = {"decode 4 x 1": torch.randn(4, 1, cut.d_model, generator=g,
                                      device="cuda"),
          "chunk 1 x 64": torch.randn(1, 64, cut.d_model, generator=g,
                                      device="cuda")}
    print(f"[chip_smoke] moe mesh: {cut.name} cut to {cut.n_layers} "
          f"layers: {nbytes / 1e9:.3f} GB of f32 leaves shared with the "
          f"ranks (routed experts {experts / 1e9:.3f} GB), prompts "
          f"{[len(p) for p in prompts]}, capacity factor "
          f"{cut.moe_capacity_factor}")
    job = start_mesh(moe_mesh_rank, MESH_DP, MESH_TP, device="cuda",
                     backend="gloo",
                     args=(cut, cut_params, prompts, digest, xs),
                     timeout=600)
    eng = PagedEngine(cut, cut_params, ServeConfig(max_slots=4, page_size=16,
                                                   max_len=512))
    reqs = [Request(prompt=p.copy(), max_new_tokens=MESH_NEW_TOKENS)
            for p in prompts]
    with DropCounter(torch) as counter:
        pd.LAUNCHES = 0
        t = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        single_drops = counter.take().get("other", (0, 0))[0]
    single_launches = pd.LAUNCHES
    single = [list(r.generated) for r in reqs]
    single_spec = moe_replay(torch, np, cut, cut_params, prompts, reqs)
    from repro_torch.models.moe import moe_ffn
    with torch.no_grad():
        ffn = {k: moe_ffn(cut_params["seg0"][0]["b0"]["moe"], x,
                          cut.moe_config())[0].cpu() for k, x in xs.items()}
    ranks = job.join()
    L = cut.n_layers
    print(f"[chip_smoke] moe mesh single device: {wall:.3f} s, "
          f"{eng.counters['decode_steps']} decode ticks, {single_launches} "
          f"decode launches, {single_drops} dropped pairs; replayed "
          f"speculation {single_spec['counters']['spec_ticks']} verify "
          f"ticks, {single_spec['counters']['spec_accepted']} drafts "
          f"accepted, the plain tokens: {single_spec['tokens'] == single}")
    by_coord = {r["coord"]: r for r in ranks}
    owners = {"ep": lambda d, m: [(d, 0), (d, 1)],
              "resident": lambda d, m: list(by_coord)}
    share = {"ep": MESH_TP, "resident": MESH_DP * MESH_TP}
    failed = []
    for r, rank in enumerate(ranks):
        d, m = rank["coord"]
        if not rank["weights_equal"]:
            failed.append(f"rank {r} weights differ from the parent's")
        for variant in MOE_MESH_VARIANTS:
            got = rank["variants"][variant]
            c = got["counters"]
            summed = sum(by_coord[o]["variants"][variant]["dropped"]
                         for o in owners[variant](d, m))
            g = got["gather_ms"]
            print(f"[chip_smoke] moe mesh rank {r} {rank['coord']}, "
                  f"{variant}: {got['wall']:.3f} s, {c['decode_steps']} "
                  f"decode ticks, decode launches {got['launches']}; "
                  f"{got['dropped']} pairs of its experts dropped ({summed} "
                  f"over its expert group, one device {single_drops}); "
                  f"{got['local_kv_heads']} KV heads; routed-expert bytes "
                  f"{got['expert_bytes']} of {experts} (views: "
                  f"{got['views']}); {len(g)} combine gathers at mean "
                  f"{np.mean(g or [np.nan]):.3f} ms per MoE layer (median "
                  f"{np.median(g or [np.nan]):.3f})")
            checks = {
                "tokens": got["tokens"] == single,
                "dropped pairs": summed == single_drops,
                "decode launches": (got["launches"] == L * c["decode_steps"]
                                    and c["decode_steps"] > 0),
                "KV heads": got["local_kv_heads"] == cut.n_kv_heads // MESH_TP,
                "expert block": (got["expert_bytes"] * share[variant]
                                 == experts and got["views"]),
                "counters": c == dict(eng.counters),
                "speculative tokens": (got["spec"]["tokens"]
                                       == single_spec["tokens"]),
                "speculative counters": (got["spec"]["counters"]
                                         == single_spec["counters"]),
                "verify launches": (
                    got["spec"]["verify"]
                    == L * got["spec"]["counters"]["spec_ticks"] > 0),
            }
            for k, want in ffn.items():
                checks[f"FFN out ({k}) bit-equal"] = torch.equal(
                    got["ffn"][k], want)
            gaps = [float((got["ffn"][k] - want).abs().max())
                    for k, want in ffn.items()]
            print(f"[chip_smoke] moe mesh rank {r}, {variant}: first "
                  f"layer's FFN out, max |mesh - one device| {gaps} at "
                  f"{list(ffn)}")
            failed += [f"rank {r} {variant} {k}" for k, ok in checks.items()
                       if not ok]
    if failed:
        raise SystemExit(f"[chip_smoke] moe mesh failed: {failed}")
    print(f"[chip_smoke] moe mesh: 4 ranks on one card (gloo) serve the "
          f"single-device tokens under EP and resident, with its dropped "
          f"pairs summed over each expert group; the first layer's FFN out "
          f"bit-equal to one device's at {list(ffn)}; launches {L} x "
          f"decode ticks; phase {time.perf_counter() - t0:.3f} s")
    release_shared(torch, cut_params)
    first = ranks[0]["variants"]
    return (sum(first[v]["launches"] + first[v]["spec"]["decode"]
                for v in MOE_MESH_VARIANTS),
            sum(first[v]["spec"]["verify"] for v in MOE_MESH_VARIANTS))


ZOO = ("recurrentgemma-2b", "mamba2-130m", "deepseek-v3-671b")
ZOO_STEPS, ZOO_FWD_S = 12, 256


def zoo_decode(torch, T, cfg, params, tokens):
    """ZOO_STEPS single-token cached decode steps; returns the last
    logits [B, vocab]."""
    caches = T.init_caches(cfg, tokens.shape[0], 32, device="cuda")
    for t in range(ZOO_STEPS):
        logits, caches, _ = T.forward(
            params, tokens[:, t:t + 1], cfg, caches=caches,
            positions=torch.arange(t, t + 1, device="cuda"))
    return logits[:, 0].float()


@phase("zoo")
def zoo_phase(torch):
    """recurrentgemma-2b (26 layers) and mamba2-130m at full width and
    depth, f32, and deepseek-v3 cut to its three dense-FFN MLA layers in
    bf16 (its 58 MoE layers, about 22.5 GB each, do not fit): a finite
    cache-free forward of 2 x ZOO_FWD_S tokens, and ZOO_STEPS single-token
    cached decode steps whose last logits match the forward's within the
    reference's 2e-3.  DeepSeek is held there on its bf16 weights widened
    to f32; its bf16 run and the MLA decode on bitstopper_xla (which prunes
    keys the dense forward keeps) report their gap to it; the MTP head's
    logits must be finite."""
    import gc

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(11)
    for arch in ZOO:
        cfg = get_config(arch)
        if arch.startswith("deepseek"):
            cfg = cfg.replace(segments=cfg.segments[:1])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.init_model(cfg, torch.Generator(device="cuda")
                              .manual_seed(0), "cuda")
        n_params = sum(p.numel() for p in _leaves(params))
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                              (2, ZOO_FWD_S)), device="cuda")
        t = time.perf_counter()
        logits, _, _ = T.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t) * 1e3
        if logits.shape != (2, ZOO_FWD_S, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"[chip_smoke] zoo {arch}: forward logits "
                             f"{tuple(logits.shape)} not finite")
        del logits
        held = (cfg, params)
        if cfg.param_dtype == "bfloat16":
            held = (cfg.replace(dtype="float32", param_dtype="float32"),
                    T._map_tree(lambda p: p.float(), params))
        hcfg, hparams = held
        full, _, _ = T.forward(hparams, tokens[:, :ZOO_STEPS], hcfg)
        full = full[:, -1].float()
        t = time.perf_counter()
        last = zoo_decode(torch, T, hcfg, hparams, tokens)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t) * 1e3 / ZOO_STEPS
        gap = float((last - full).abs().max())
        ok = bool(torch.allclose(last, full, atol=2e-3, rtol=2e-3))
        print(f"[chip_smoke] zoo {arch}: {cfg.n_layers} layers, "
              f"{n_params} {cfg.param_dtype} parameters, init and forward "
              f"{time.perf_counter() - t0:.2f} s; cache-free forward 2 x "
              f"{ZOO_FWD_S} finite in {fwd_ms:.1f} ms; {ZOO_STEPS} decode "
              f"steps ({dec_ms:.2f} ms each, {hcfg.param_dtype}): last "
              f"logits max|diff| {gap:.3e} from the forward's (max|logit| "
              f"{float(full.abs().max()):.3f}), within 2e-3: {ok}; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
              f" GiB")
        if not ok:
            raise SystemExit(f"[chip_smoke] zoo {arch}: decode leaves the "
                             f"forward's logits by {gap}")
        if hcfg is not cfg:
            runs = [("bf16 xla", cfg, params)]
            runs.append(("f32 bitstopper_xla", hcfg.replace(
                attn_impl="bitstopper_xla",
                bitstopper=BitStopperConfig(alpha=0.6)), hparams))
            for label, c, p in runs:
                other = zoo_decode(torch, T, c, p, tokens)
                if not bool(torch.isfinite(other).all()):
                    raise SystemExit(f"[chip_smoke] zoo {arch} {label}: "
                                     f"decode logits not finite")
                same = float((other.argmax(-1) == last.argmax(-1))
                             .float().mean())
                print(f"[chip_smoke] zoo {arch} decode on {label}: last "
                      f"logits max|diff| {float((other - last).abs().max()):.3e}"
                      f" from the f32 xla decode's, argmax equal in "
                      f"{same * 100:.0f}% of rows (reported, not checked)")
            h, _, _ = T.run_segments(params, L.embed(
                params["embed"], tokens[:, :ZOO_STEPS]).to(
                    cfg.activation_dtype),
                torch.arange(ZOO_STEPS, device="cuda"), cfg)
            mtp = T.mtp_logits(params, tokens[:, :ZOO_STEPS], h, cfg,
                               torch.arange(ZOO_STEPS, device="cuda"))
            if not bool(torch.isfinite(mtp).all()):
                raise SystemExit(f"[chip_smoke] zoo {arch}: MTP logits not "
                                 f"finite")
            print(f"[chip_smoke] zoo {arch}: MTP head logits "
                  f"{tuple(mtp.shape)} finite")
        del params, hparams, held, full, last
        gc.collect()
        torch.cuda.empty_cache()


BASELINE_S = 1024                # the baselines phase's prompt
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 8, 256   # the launcher's defaults
TRAIN_CUT = 2                    # depth of the train phase's (b) and (c)
TRAIN_CPU_TOL = 1e-4             # card vs CPU loss and grad norm, relative


def layer0_qkv(torch, cfg, params, tokens):
    """Layer 0's rotated q and k and its v over ``tokens`` [1, S], head
    major: [H, S, D] each."""
    from repro_torch.models import layers as L
    p = params["seg0"][0]["b0"]
    h = L.norm(p["norm1"], L.embed(params["embed"], tokens))
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
    q = L.rope(L.linear(p["attn"]["wq"], h), pos, cfg.rope_theta)
    k = L.rope(L.linear(p["attn"]["wk"], h), pos, cfg.rope_theta)
    v = L.linear(p["attn"]["wv"], h)
    return tuple(t[0].transpose(0, 1).contiguous() for t in (q, k, v))


def baseline_runs(torch, q, k, v):
    """The paper's comparison on one device: (out, integer info) of dense
    INT12, Sanger, SOFA, TokenPicker and BESF, causal, and each call's ms."""
    from repro_torch.core import baselines as B
    from repro_torch.core.besf import besf_attention
    runs = {}
    for name, fn in (("dense", B.dense_attention),
                     ("sanger", B.sanger_attention),
                     ("sofa", B.sofa_attention),
                     ("tokenpicker", B.tokenpicker_attention)):
        t = time.perf_counter()
        out, info = fn(q, k, v, causal=True)
        keys = [key for key in ("mask", "kept", "valid", "chunks_fetched")
                if info.get(key) is not None]
        runs[name] = (out, {key: info[key] for key in keys})
        if q.is_cuda:
            torch.cuda.synchronize()
        runs[name] += ((time.perf_counter() - t) * 1e3,)
    t = time.perf_counter()
    res = besf_attention(q, k, v, causal=True)
    if q.is_cuda:
        torch.cuda.synchronize()
    runs["besf"] = (res.out, res.stats._asdict(),
                    (time.perf_counter() - t) * 1e3)
    return runs


@phase("baselines")
def baselines_phase(torch, cfg, params):
    """The paper's baselines and traffic statistics on layer 0 of
    full-width stablelm-1.6b over one 1024-token prompt (32 heads of 64,
    causal): dense INT12, Sanger, SOFA, TokenPicker and BESF on the card
    and on the CPU; every mask and counter equal, ``out`` within OUT_TOL;
    then each method's Complexity in both accounting modes and BESF's K+V
    bytes and bit-MACs relative to Sanger and SOFA (counts, not times)."""
    import numpy as np
    from repro_torch.core import stats as ST
    tokens = torch.as_tensor(np.random.default_rng(13).integers(
        0, cfg.vocab, (1, BASELINE_S)), device="cuda")
    with torch.no_grad():
        q, k, v = layer0_qkv(torch, cfg, params, tokens)
        card = baseline_runs(torch, q, k, v)
        cpu = baseline_runs(torch, q.cpu(), k.cpu(), v.cpu())
    H, S, d = q.shape
    failed = []
    for name, (out, info, ms) in card.items():
        c_out, c_info, c_ms = cpu[name]
        same = {key: bool(torch.equal(val.cpu(), c_info[key]))
                for key, val in info.items()}
        err = float((out.cpu() - c_out).abs().max())
        failed += [f"{name} {key}" for key, ok in same.items() if not ok]
        if not err <= OUT_TOL:
            failed.append(f"{name} out {err}")
        print(f"[chip_smoke] baselines {name}: card {ms:.1f} ms, CPU "
              f"{c_ms:.1f} ms; integers equal to the CPU's {same}; out "
              f"max|diff| {err:.3e}")
    if failed:
        raise SystemExit(f"[chip_smoke] baselines: card and CPU differ: "
                         f"{failed}")
    summary = {}
    for mode in ("per_pair", "shared"):
        dn = ST.dense_complexity(S, S, d, d)
        cx = {"dense": ST.Complexity(dn.k_bytes * H, dn.v_bytes * H,
                                     dn.compute_bitmacs * H)}
        for name in ("sanger", "sofa"):
            cx[name] = ST.predictor_complexity(S, S, d, d,
                                               card[name][1]["kept"], 4,
                                               mode=mode, batch=H)
        tp = card["tokenpicker"][1]
        cx["tokenpicker"] = ST.chunk_progressive_complexity(
            tp["chunks_fetched"], tp["kept"], d, d, mode=mode)
        bs = card["besf"][1]
        cx["besf"] = ST.besf_complexity(bs["planes_fetched"],
                                        bs["survivors"], d, d, mode=mode)
        summary[mode] = {
            "complexity": {n: {"k_bytes": c.k_bytes, "v_bytes": c.v_bytes,
                               "bitmacs": c.compute_bitmacs}
                           for n, c in cx.items()},
            "besf_vs": {n: cx["besf"].normalized_to(cx[n])
                        for n in ("dense", "sanger", "sofa", "tokenpicker")}}
        for n, c in cx.items():
            print(f"[chip_smoke] baselines {mode} {n}: K {c.k_bytes:.0f} B, "
                  f"V {c.v_bytes:.0f} B, {c.compute_bitmacs:.0f} bit-MACs")
        for n, r in summary[mode]["besf_vs"].items():
            print(f"[chip_smoke] baselines {mode}: BESF / {n}: K+V bytes "
                  f"{r['mem']:.4f}, bit-MACs {r['compute']:.4f}")
    print(f"[chip_smoke] baselines summary: {json.dumps(summary)}")
    return summary


def tree_bytes(root):
    import os
    return sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(root) for n in names)


def train_remat_step(torch, TS, O, cfg, tcfg, params, batch):
    """Loss, global grad norm, peak bytes above the state and ms of one
    forward and backward under each remat policy, from the same params."""
    out = {}
    for policy in ("none", "full", "dots"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss, grads = TS.value_and_grad(params, batch,
                                        cfg.replace(remat=policy), tcfg)
        gnorm = O.global_norm(grads)
        torch.cuda.synchronize()
        out[policy] = {"loss": float(loss), "grad_norm": float(gnorm),
                       "peak_bytes": torch.cuda.max_memory_allocated() - base,
                       "ms": (time.perf_counter() - t) * 1e3}
        del grads
    return out


@phase("train")
def train_phase(torch):
    """Single-device training of stablelm-1.6b at its published width (f32,
    AdamW in f32): (a) full depth through ``Trainer`` at the launcher's
    defaults (batch 8, seq 256, 4 steps): ms per step after the first,
    tokens/s, peak memory, loss and grad norm per step, its final
    checkpoint's bytes and ms; then one forward and backward under each
    remat policy from the trained state (losses and grad norms equal, peak
    memory of each); (b) depth 2, one 1x128 batch: the card's loss and
    global grad norm within TRAIN_CPU_TOL of the CPU's; (c) depth 2 under
    deterministic algorithms: train(4) straight equals train(2) and a
    resumed train(2) bit for bit, with checkpoint bytes and save and load
    ms."""
    import os
    import shutil
    import tempfile
    import warnings

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("stablelm-1.6b")
    tcfg = TS.TrainConfig(optimizer=O.AdamWConfig(lr=3e-4),
                          total_steps=TRAIN_STEPS,
                          warmup_steps=max(TRAIN_STEPS // 10, 1))
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    print(f"[chip_smoke] train checkpoints under {root}: "
          f"{shutil.disk_usage(root).free / 2**30:.1f} GiB free")

    def trainer(c, d, steps):
        return Trainer(c, tcfg, TrainerConfig(steps=steps, ckpt_every=100,
                                              ckpt_dir=f"{root}/{d}",
                                              log_every=0),
                       data_cfg=data, device="cuda")

    summary, failed = {}, []
    try:
        # (a) full depth through the Trainer.
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = trainer(cfg, "a", TRAIN_STEPS)
        state = tr.train()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in O.tree_leaves(state["params"]))
        ms = [m["step_time"] * 1e3 for m in tr.metrics_log]
        steady = float(np.mean(ms[1:]))
        ck = f"{root}/a/step_{TRAIN_STEPS:08d}"
        summary["a"] = {
            "params": n_params, "step_ms": ms, "steady_step_ms": steady,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
            "peak_bytes": peak,
            "loss": [m["loss"] for m in tr.metrics_log],
            "grad_norm": [m["grad_norm"] for m in tr.metrics_log],
            "ckpt_bytes": tree_bytes(ck),
            "ckpt_save_ms": [e[2] * 1e3 for e in tr.ckpt_events]}
        shutil.rmtree(f"{root}/a", ignore_errors=True)
        if not all(np.isfinite(summary["a"]["loss"] +
                               summary["a"]["grad_norm"])):
            failed.append("(a) losses or grad norms not finite")
        batch = torch.as_tensor(tr.dataset.batch_at(TRAIN_STEPS),
                                device="cuda")
        rem = train_remat_step(torch, TS, O, cfg, tcfg, state["params"],
                               batch)
        summary["remat"] = rem
        for policy in ("full", "dots"):
            for key in ("loss", "grad_norm"):
                if rem[policy][key] != rem["none"][key]:
                    failed.append(f"remat {policy} {key} "
                                  f"{rem[policy][key]!r} != "
                                  f"{rem['none'][key]!r}")
        a = summary["a"]
        print(f"[chip_smoke] train (a) {cfg.name} full depth "
              f"({cfg.n_layers} layers, {n_params} f32 parameters), batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}: step ms "
              f"{[round(x, 3) for x in ms]}"
              f", {steady:.3f} ms a step after the first, "
              f"{a['tokens_per_s']:.1f} tokens/s, peak "
              f"{peak / 2**30:.3f} GiB; loss {a['loss']}, grad norm "
              f"{a['grad_norm']}; final checkpoint {a['ckpt_bytes']} bytes "
              f"in {a['ckpt_save_ms']} ms")
        for policy, r in rem.items():
            print(f"[chip_smoke] train (a) remat {policy}: loss "
                  f"{r['loss']!r}, grad norm {r['grad_norm']!r}, peak "
                  f"{r['peak_bytes'] / 2**30:.3f} GiB above the state, "
                  f"{r['ms']:.1f} ms")
        del tr, state, batch
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the card against the CPU, depth TRAIN_CUT.
        cut = cfg.replace(segments=((cfg.segments[0][0], TRAIN_CUT),))
        params = TS.trainable(T.init_model(
            cut, torch.Generator(device="cuda").manual_seed(1), "cuda"))
        host = O.tree_map(lambda p: p.detach().cpu().requires_grad_(True),
                          params)
        tokens = np.random.default_rng(3).integers(0, cfg.vocab, (1, 128))
        res = {}
        for label, dev, p in (("card", "cuda", params), ("host", "cpu", host)):
            t = time.perf_counter()
            loss, grads = TS.value_and_grad(
                p, torch.as_tensor(tokens, device=dev), cut, tcfg)
            res[label] = (float(loss), float(O.global_norm(grads)),
                          (time.perf_counter() - t) * 1e3, grads)
        leaf_gap = max(
            float((g.cpu() - h).abs().max()) / max(float(h.abs().max()),
                                                   1e-30)
            for g, h in zip(O.tree_leaves(res["card"][3]),
                            O.tree_leaves(res["host"][3])))
        rel = {key: abs(res["card"][i] - res["host"][i])
               / abs(res["host"][i])
               for i, key in enumerate(("loss", "grad_norm"))}
        summary["b"] = {"card": res["card"][:3], "cpu": res["host"][:3],
                        "rel": rel, "max_leaf_gap": leaf_gap}
        failed += [f"(b) {k} {v:.3e}" for k, v in rel.items()
                   if not v <= TRAIN_CPU_TOL]
        print(f"[chip_smoke] train (b) depth {TRAIN_CUT}, 1 x 128: card "
              f"loss {res['card'][0]!r}, grad norm {res['card'][1]!r} "
              f"({res['card'][2]:.1f} ms); CPU loss {res['host'][0]!r}, "
              f"grad norm {res['host'][1]!r} ({res['host'][2]:.1f} ms); "
              f"relative gaps {rel}, largest leaf gap {leaf_gap:.3e} of "
              f"that leaf's max |g| (tolerance {TRAIN_CPU_TOL} on loss and "
              f"grad norm)")
        del params, host, res, grads
        gc.collect()
        torch.cuda.empty_cache()

        # (c) resume, bit for bit, under deterministic algorithms.
        env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        prev = (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                straight = trainer(cut, "c1", TRAIN_STEPS).train()
                first = trainer(cut, "c2", TRAIN_STEPS // 2)
                first.train()
                resumed = trainer(cut, "c2", TRAIN_STEPS)
                state = resumed.train()
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
            if env is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        refused = sorted({str(w.message)[:160] for w in caught
                          if "determinis" in str(w.message)})
        pairs = [(x, y) for key in ("params",)
                 for x, y in zip(O.tree_leaves(state[key]),
                                 O.tree_leaves(straight[key]))]
        pairs += list(zip(O.tree_leaves([state["opt"]["m"],
                                         state["opt"]["v"]]),
                          O.tree_leaves([straight["opt"]["m"],
                                         straight["opt"]["v"]])))
        differ = sum(not torch.equal(x, y) for x, y in pairs)
        same_step = int(state["opt"]["step"]) == TRAIN_STEPS
        if differ or not same_step:
            failed.append(f"(c) resumed state differs from the straight "
                          f"run's in {differ} of {len(pairs)} leaves")
        events = first.ckpt_events + resumed.ckpt_events
        summary["c"] = {
            "leaves": len(pairs), "differ": differ,
            "ckpt_bytes": tree_bytes(f"{root}/c2/step_"
                                     f"{TRAIN_STEPS // 2:08d}"),
            "save_ms": [e[2] * 1e3 for e in events if e[0] == "save"],
            "load_ms": [e[2] * 1e3 for e in events if e[0] == "load"],
            "nondeterministic_ops": refused}
        c = summary["c"]
        print(f"[chip_smoke] train (c) depth {TRAIN_CUT}: train("
              f"{TRAIN_STEPS}) against train({TRAIN_STEPS // 2}) + resumed "
              f"train({TRAIN_STEPS // 2}): {len(pairs) - differ} of "
              f"{len(pairs)} parameter and moment leaves bit-equal; a "
              f"checkpoint {c['ckpt_bytes']} bytes, saves "
              f"{[round(x, 1) for x in c['save_ms']]} ms, load "
              f"{[round(x, 1) for x in c['load_ms']]} ms; ops without a "
              f"deterministic form: {refused or 'none'}")
        del straight, state, first, resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[chip_smoke] train summary: {json.dumps(summary)}")
    if failed:
        raise SystemExit(f"[chip_smoke] train failed: {failed}")
    return summary


MESH_DP, MESH_TP = 2, 2
MESH_NEW_TOKENS = 8
MESH_DEPTH = 4                   # the stablelm and MoE mesh paths' cut
# The mesh-state scenario's plan on the greedy trace (four prompts of the
# main trace, 8 new tokens): a crash after the tick-8 snapshot, restored
# from it; the 1x2 mesh restores the tick-4 one.
MESH_CHAOS_PLAN = (("crash", 10),)
MESH_SNAPSHOT_EVERY = 4
MESH_RESTORE_STEP = 4


def _shard_slices(kind, d, m, B, Hq, Hkv):
    """Index tuples of shard (d, m)'s block in each kernel operand and
    output (``kind`` decode or verify): its slots over "data", its KV heads
    (and their query heads) over "model"."""
    b = slice(d * B // MESH_DP, (d + 1) * B // MESH_DP)
    hq = slice(m * Hq // MESH_TP, (m + 1) * Hq // MESH_TP)
    hk = slice(m * Hkv // MESH_TP, (m + 1) * Hkv // MESH_TP)
    allx = slice(None)
    if kind == "decode":
        return dict(q=(b, hq), out=(b, hq), rounds_h=(b, hk), surv=(b, hq),
                    vf=(b, hk), slots=(b,), hk=hk)
    return dict(q=(b, allx, hq), out=(b, allx, hq), rounds_h=(b, hk),
                surv=(b, allx, hq), vf=(b, allx, hk), slots=(b,), hk=hk)


def _v_fetched(kind, surv, B, Hkv, G, MB, bs):
    """V pages read per (slot, KV head[, query]) from per-head survivors."""
    if kind == "decode":
        return surv.reshape(B, Hkv, G, MB, bs).any(4).any(2)
    Sq = surv.shape[1]
    return surv.reshape(B, Sq, Hkv, G, MB, bs).any(5).any(3)


def shard_kernel_check(torch, kind, mod, sq, seed, shapes, Hkv, label):
    """One paged kernel (``kind`` decode or verify, module ``mod``) at
    ``shapes`` and on each of the 2x2 mesh's four shards at local geometry
    (half the slots, half the heads): each shard's out bit-equal to its
    block of the full run, its per-head rounds, survivors and V pages
    equal, and the full slot-wide rounds the max over its "model" shards.
    Each shard kernel timed alone beside its bound (from the kernel's own
    byte and operation counts).  Returns {"shard_ms", "shard_bound_ms",
    "shard_launches", "full_ms"}."""
    from repro_torch.core.besf import BitStopperConfig
    cfg = BitStopperConfig(alpha=0.6)
    args = decode_case(torch, seed, Hkv=Hkv, Sq=sq, **shapes)
    q, kq, v, table, lengths, q_pos, k_amax, v_amax = args
    B, Hq = q.shape[0], q.shape[-2]
    P, bits, bs8, Hkv, D = kq.shape
    bs, MB, G = bs8 * 8, table.shape[1], Hq // Hkv
    f_out, f_rh, f_surv = mod.launch_kernel(*args, cfg=cfg)
    if kind == "verify":
        f_surv = f_surv.reshape(B, sq, Hq, -1)
    f_vf = _v_fetched(kind, f_surv, B, Hkv, G, MB, bs)
    shard_rounds = {}
    times, bounds, launches = [], [], 0
    for d in range(MESH_DP):
        for m in range(MESH_TP):
            ix = _shard_slices(kind, d, m, B, Hq, Hkv)
            hk, sl = ix["hk"], ix["slots"]
            sargs = (q[ix["q"]].contiguous(),
                     kq[:, :, :, hk].contiguous(),
                     v[:, :, hk].contiguous(), table[sl].contiguous(),
                     lengths[sl].contiguous(), q_pos[sl].contiguous(),
                     k_amax[hk].contiguous(), v_amax[hk].contiguous())
            s_out, s_rh, s_surv = mod.launch_kernel(*sargs, cfg=cfg)
            launches += 1
            b = s_out.shape[0]
            if kind == "verify":
                s_surv = s_surv.reshape(b, sq, Hq // MESH_TP, -1)
            s_vf = _v_fetched(kind, s_surv, b, Hkv // MESH_TP, G, MB, bs)
            checks = {"out": (s_out, f_out[ix["out"]]),
                      "rounds per KV head": (s_rh, f_rh[ix["rounds_h"]]),
                      "survivors": (s_surv, f_surv[ix["surv"]]),
                      "v_fetched": (s_vf, f_vf[ix["vf"]])}
            for what, (a, w) in checks.items():
                if not torch.equal(a, w):
                    raise SystemExit(
                        f"[chip_smoke] mesh kernels: {kind} {label} shard "
                        f"({d}, {m}) {what} differs from its block of "
                        f"the full run in {int((a != w).sum())} entries")
            shard_rounds.setdefault(d, []).append(s_rh.amax(1))
            kargs, *held = mod.kernel_args(*sargs, cfg=cfg, stats=False)
            times.append(cuda_ms(torch, lambda: mod.launch_c(*kargs),
                                 iters=50, warmup=5))
            if kind == "decode":
                nbytes, ops = decode_bytes_ops(sargs, s_rh, s_surv,
                                               stats=False)
            else:
                nbytes, ops, _, _ = verify_bytes_ops(
                    sargs, s_rh, s_surv.reshape(b, sq * Hq // MESH_TP, -1))
            bounds.append(max(nbytes / HBM_BYTES_PER_S,
                              ops / INT8_OPS_PER_S) * 1e3)
    for d, parts in shard_rounds.items():
        b = slice(d * B // MESH_DP, (d + 1) * B // MESH_DP)
        want = f_rh.amax(1)[b]
        if not torch.equal(torch.stack(parts).amax(0), want):
            raise SystemExit(f"[chip_smoke] mesh kernels: {kind} {label} "
                             f"full rounds are not the max over the model "
                             f"shards' of data shard {d}")
    kargs, *held = mod.kernel_args(*args, cfg=cfg, stats=False)
    full_ms = cuda_ms(torch, lambda: mod.launch_c(*kargs), iters=50,
                      warmup=5)
    print(f"[chip_smoke] mesh kernels: paged_{kind} {label} on 4 shards of "
          f"({B // MESH_DP} slots, {Hq // MESH_TP} heads of {D}): out, "
          f"per-head rounds, survivors and v_fetched equal to the full "
          f"run's blocks; full rounds the max over model shards; kernel "
          f"alone per shard {[round(t, 4) for t in times]} ms (bounds "
          f"{[round(x, 5) for x in bounds]}), full geometry "
          f"{full_ms:.4f} ms")
    return {"shard_ms": times, "shard_bound_ms": bounds,
            "shard_launches": launches, "full_ms": full_ms}


@phase("mesh kernels")
def mesh_kernel_phase(torch):
    """The decode and verify kernels on each of the 2x2 mesh's four shards
    at local geometry (:func:`shard_kernel_check`): at the main shape
    (B=4, H=32, D=64, bs=16, MB=32, alpha 0.6, hot directions; shards of 2
    slots and 16 heads) and at qwen2-moe-a2.7b's attention shape (B=4,
    H=16, D=128; shards of 2 slots and 8 heads, what each rank of the MoE
    mesh runs).  Returns {kernel: {D=64 fields, "d128": {...}}}."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    out = {}
    for kind, mod, sq, seed in (("decode", pd, 1, 100),
                                ("verify", pv, SPEC_K + 1, 200)):
        row = shard_kernel_check(torch, kind, mod, sq, seed, DECODE_SHAPES,
                                 32, "D=64")
        row["d128"] = shard_kernel_check(torch, kind, mod, sq, seed + 50,
                                         MOE_SHAPES, 16, "D=128")
        out[f"paged_{kind}"] = row
    return out


def params_digest(torch, params):
    """Per-leaf int64 sums of each parameter's 32-bit words, in leaf
    order: equal digests mean the same bits (a checksum)."""
    out = []
    for t in _leaves(params):
        w = t.detach().contiguous().view(-1).view(torch.int32)
        out.append(sum(int(torch.sum(c, dtype=torch.int64))
                       for c in w.split(1 << 26)))
    return out


def mesh_serve(torch, np, eng, prompts, new_tokens, count_gathers=False):
    """Serve ``prompts`` on ``eng``; the tokens, counters, launches of both
    paged kernels, pure decode tick ms, and per attention layer the
    gather's ms (``gather_shards``: the device-to-host copy, which waits
    for the rank's queued work, the collective, the copy back) and its
    collective's alone (``all_gather``, which waits for the slowest
    rank)."""
    import torch.distributed as dist
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.models import attention as A
    from repro_torch.serving import Request
    reqs = [Request(prompt=p.copy(), max_new_tokens=new_tokens)
            for p in prompts]
    ticks = []
    real_step = eng.step

    def timed_step():
        before = dict(eng.counters)
        t = time.perf_counter()
        res = real_step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        if (eng.counters["decode_steps"] > before["decode_steps"]
                and eng.counters["prefill_chunks"] == before[
                    "prefill_chunks"]):
            ticks.append(dt)
        return res

    gathers, collectives = [], []
    real_gather, real_all_gather = A.gather_shards, dist.all_gather

    def timed(fn, log):
        def run(*a, **kw):
            t = time.perf_counter()
            res = fn(*a, **kw)
            log.append((time.perf_counter() - t) * 1e3)
            return res
        return run

    eng.step = timed_step
    A.gather_shards = timed(real_gather, gathers)
    dist.all_gather = timed(real_all_gather, collectives)
    pd.LAUNCHES = pv.LAUNCHES = 0
    t = time.perf_counter()
    try:
        eng.generate(reqs)
        torch.cuda.synchronize()
    finally:
        A.gather_shards, dist.all_gather = real_gather, real_all_gather
    return {"tokens": [list(r.generated) for r in reqs],
            "wall": time.perf_counter() - t,
            "counters": dict(eng.counters),
            "decode_launches": pd.LAUNCHES, "verify_launches": pv.LAUNCHES,
            "tick_ms": ticks, "gather_ms": gathers,
            "collective_ms": collectives}


def mesh_state_rank(torch, np, mesh, device, cfg, params, greedy, dirs):
    """The mesh-state scenario on this rank: (a) the main trace on an
    oversubscribed pool with a swap tier; (b) (b)'s prefix-store trace
    cold on the mesh (its flushed store the parent warms one device from)
    and warm from the store a single device flushed; (c) the greedy trace
    through ``serve_with_chaos`` under ``MESH_CHAOS_PLAN``, then the
    snapshot of step ``MESH_RESTORE_STEP`` restored on a 1x2 mesh of ranks
    0-1; (d) the greedy trace disaggregated from a single-device prefill
    engine into a mesh decode engine (``insert``)."""
    from repro_torch.checkpoint.store import load_snapshot
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.runtime.fault_tolerance import ElasticMeshManager
    from repro_torch.serving import (FaultPlan, PagedEngine, Request,
                                     ServeConfig, serve_with_chaos)
    from repro_torch.serving.frontdoor import DisaggController
    from repro_torch.sharding.api import mesh_group
    base = dict(max_slots=4, page_size=16, max_len=512)
    out, tiers = {}, TierLog(torch)

    def served(eng, reqs, seed=0):
        pd.LAUNCHES = 0
        t = time.perf_counter()
        eng.generate(reqs, seed)
        torch.cuda.synchronize()
        return {"tokens": [list(r.generated) for r in reqs],
                "counters": dict(eng.counters), "launches": pd.LAUNCHES,
                "wall": time.perf_counter() - t}

    eng = PagedEngine(cfg, params, ServeConfig(
        mesh=mesh, oversubscribe=True, pool_blocks=OVERSUB_POOL_BLOCKS,
        swap_host_bytes=SWAP_HOST_BYTES, **base), device=device)
    tiers.watch(eng)
    out["swap"] = served(eng, make_requests(np, Request, 0, 8, 32,
                                            cfg.vocab))
    out["swap"]["memory"] = eng.memory_report()
    out["swap"]["events"] = {k: list(v) for k, v in tiers.events.items()}
    prompts = store_prompts(np, cfg.vocab)
    store = dict(base, max_slots=1, pool_blocks=STORE_POOL_BLOCKS)
    with tiers.store_patch():
        for name, d in (("store_cold", dirs["mesh_store"]),
                        ("store_warm", dirs["single_store"])):
            for k in tiers.events:
                tiers.events[k].clear()
            eng = PagedEngine(cfg, params, ServeConfig(
                mesh=mesh, prefix_store_dir=d, **store), device=device)
            out[name] = served(eng, [Request(prompt=p.copy(),
                                             max_new_tokens=STORE_NEW)
                                     for p in prompts])
            if name == "store_cold":
                t = time.perf_counter()
                out[name]["flushed"] = eng.flush_prefixes()
                out[name]["flush_s"] = time.perf_counter() - t
            out[name]["events"] = {k: list(v)
                                   for k, v in tiers.events.items()}

    def make():
        return PagedEngine(cfg, params, ServeConfig(mesh=mesh, **base),
                           device=device)

    pd.LAUNCHES = 0
    t = time.perf_counter()
    reqs, rep = serve_with_chaos(
        make, [Request(prompt=p.copy(), max_new_tokens=MESH_NEW_TOKENS)
               for p in greedy],
        plan=FaultPlan.scripted(list(MESH_CHAOS_PLAN)),
        snapshot_dir=dirs["mesh_snaps"], snapshot_every=MESH_SNAPSHOT_EVERY)
    torch.cuda.synchronize()
    out["chaos"] = {"tokens": [list(r.generated) for r in reqs],
                    "report": {k: v for k, v in rep.items()
                               if k != "engine_counters"},
                    "launches": pd.LAUNCHES,
                    "wall": time.perf_counter() - t}
    mgr = ElasticMeshManager(model_parallel=MESH_TP, devices_per_node=1)
    sub = mgr.rebuild_mesh(mgr.decide(healthy_nodes=MESH_TP))
    mesh_group(sub)
    out["restore"] = None
    if sub.get_coordinate() is not None:
        snap, _ = load_snapshot(dirs["mesh_snaps"], MESH_RESTORE_STEP)
        eng = PagedEngine(cfg, params, ServeConfig(mesh=sub, **base),
                          device=device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.restore(snap)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t) * 1e3
        pd.LAUNCHES = 0
        eng.run(0)
        torch.cuda.synchronize()
        out["restore"] = {
            "tokens": [list(eng.requests[r].generated)
                       for r in sorted(eng.requests)],
            "restore_ms": restore_ms, "launches": pd.LAUNCHES,
            "counters": dict(eng.counters)}
    ctl = DisaggController(
        PagedEngine(cfg, params, ServeConfig(**dict(base, max_slots=1)),
                    device=device),
        PagedEngine(cfg, params, ServeConfig(mesh=mesh, **base),
                    device=device))
    pd.LAUNCHES = 0
    reqs = [Request(prompt=p.copy(), max_new_tokens=MESH_NEW_TOKENS)
            for p in greedy]
    ctl.generate(reqs)
    torch.cuda.synchronize()
    out["insert"] = {"tokens": [list(r.generated) for r in reqs],
                     "launches": pd.LAUNCHES,
                     "decode_steps": ctl.decode_engine.counters[
                         "decode_steps"],
                     "prefill_steps": ctl.prefill_engine.counters[
                         "decode_steps"],
                     "inserted": ctl.decode_engine.counters[
                         "prefixes_inserted"]}
    return out


def replay_of(prompts, tokens):
    """A :class:`ReplayDrafter` of a served trace's prompts and tokens."""
    import types
    import numpy as np
    return ReplayDrafter(np, [types.SimpleNamespace(prompt=p, generated=t)
                              for p, t in zip(prompts, tokens)])


def mesh_rank(mesh, device, cfg, params, greedy, digest, dirs):
    """A rank of the 2x2 mesh phase: the greedy trace through the decode
    kernel and again speculatively, drafts replaying its tokens, through
    the verify kernel, on this rank's block, then the mesh-state scenario
    (:func:`mesh_state_rank`).  Checks that its weights (CUDA IPC from the
    parent) are the parent's."""
    import numpy as np
    import torch
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    same = params_digest(torch, params) == digest
    scfg = ServeConfig(max_slots=4, page_size=16, max_len=512, mesh=mesh)
    t = time.perf_counter()
    PagedEngine(cfg, params, scfg, device=device).generate(
        [Request(prompt=greedy[0][:16].copy(), max_new_tokens=2)])
    warm = time.perf_counter() - t
    eng = PagedEngine(cfg, params, scfg, device=device)
    res = {"coord": tuple(mesh.get_coordinate()), "weights_equal": same,
           "warmup_s": warm, "fused": eng.cfg.fused_decode,
           "local_kv_heads": int(eng.caches["seg0"][0]["b0"]["kq"].shape[3])}
    res["greedy"] = mesh_serve(torch, np, eng, greedy, MESH_NEW_TOKENS)
    spec = PagedEngine(cfg, params, ServeConfig(
        max_slots=4, page_size=16, max_len=512, mesh=mesh,
        speculative="draft", draft_k=SPEC_K), device=device,
        drafter=replay_of(greedy, res["greedy"]["tokens"]))
    res["replay"] = mesh_serve(torch, np, spec, greedy, MESH_NEW_TOKENS)
    t = time.perf_counter()
    res["state"] = mesh_state_rank(torch, np, mesh, device, cfg, params,
                                   greedy, dirs)
    res["state_s"] = time.perf_counter() - t
    return res


def same_files(a, b):
    """Whether the directory trees ``a`` and ``b`` hold the same files with
    the same bytes; and how many files."""
    import filecmp
    import os

    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, n), root)
                      for d, _, names in os.walk(root) for n in names)

    files = listing(a)
    return (files == listing(b) and all(
        filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False)
        for f in files)), len(files)


def mesh_state_single(torch, np, cfg, params, greedy, dirs):
    """The mesh-state scenario's single-device runs beside the ranks: (a)
    the swap trace, (c) the chaos trace (its snapshots the mesh's must
    equal byte for byte)."""
    from repro_torch.serving import (FaultPlan, PagedEngine, Request,
                                     ServeConfig, serve_with_chaos)
    base = dict(max_slots=4, page_size=16, max_len=512)
    eng = PagedEngine(cfg, params, ServeConfig(
        oversubscribe=True, pool_blocks=OVERSUB_POOL_BLOCKS,
        swap_host_bytes=SWAP_HOST_BYTES, **base))
    reqs = make_requests(np, Request, 0, 8, 32, cfg.vocab)
    eng.generate(reqs)
    out = {"swap": {"tokens": [list(r.generated) for r in reqs],
                    "counters": dict(eng.counters),
                    "memory": eng.memory_report()}}
    reqs, rep = serve_with_chaos(
        lambda: PagedEngine(cfg, params, ServeConfig(**base)),
        [Request(prompt=p.copy(), max_new_tokens=MESH_NEW_TOKENS)
         for p in greedy],
        plan=FaultPlan.scripted(list(MESH_CHAOS_PLAN)),
        snapshot_dir=dirs["single_snaps"],
        snapshot_every=MESH_SNAPSHOT_EVERY)
    out["chaos"] = {"tokens": [list(r.generated) for r in reqs],
                    "report": {k: v for k, v in rep.items()
                               if k != "engine_counters"}}
    return out


def mesh_state_report(torch, np, cfg, params, ranks, single, greedy_tokens,
                      dirs, store_cold):
    """Holds the ranks' mesh-state results to one device's and prints
    them; after the spawn one device warms from the mesh's store and
    restores the mesh's snapshot.  Returns the failed checks and the
    decode launches of rank 0's state runs."""
    from repro_torch.checkpoint.store import load_snapshot
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    base = dict(max_slots=4, page_size=16, max_len=512)
    L = cfg.n_layers
    warm = PagedEngine(cfg, params, ServeConfig(
        prefix_store_dir=dirs["mesh_store"], **dict(
            base, max_slots=1, pool_blocks=STORE_POOL_BLOCKS)))
    reqs = [Request(prompt=p.copy(), max_new_tokens=STORE_NEW)
            for p in store_prompts(np, cfg.vocab)]
    warm.generate(reqs)
    warm_single = [list(r.generated) for r in reqs]
    snap, _ = load_snapshot(dirs["mesh_snaps"], MESH_RESTORE_STEP)
    eng = PagedEngine(cfg, params, ServeConfig(**base))
    eng.restore(snap)
    eng.run(0)
    restored_single = [list(eng.requests[r].generated)
                       for r in sorted(eng.requests)]
    store_same, n_store = same_files(dirs["mesh_store"],
                                     dirs["single_store"])
    snaps_same, n_snaps = same_files(dirs["mesh_snaps"],
                                     dirs["single_snaps"])
    warmed = (warm_single == store_cold
              and warm.counters["prefix_store_hits"] > 0)
    restored = restored_single == greedy_tokens
    checks = {
        "store records byte-equal": store_same and n_store > 0,
        "snapshots byte-equal": snaps_same and n_snaps > 0,
        "one device warms from the mesh's store": warmed,
        "one device restores the mesh's snapshot": restored,
    }
    failed = [k for k, ok in checks.items() if not ok]
    for r, rank in enumerate(ranks):
        st = rank["state"]
        sw, cold, wm = st["swap"], st["store_cold"], st["store_warm"]
        c = sw["counters"]
        rchecks = {
            "swap tokens": sw["tokens"] == single["swap"]["tokens"],
            "swap counters": c == single["swap"]["counters"],
            "swapped out and in": c["swap_outs"] >= 1 and c["swap_ins"] >= 1,
            "swap launches": sw["launches"] == L * c["decode_steps"],
            "store cold tokens": cold["tokens"] == store_cold,
            "warm from one device's store": (
                wm["tokens"] == store_cold
                and wm["counters"]["prefix_store_hits"] > 0),
            "warm launches": wm["launches"] == L * wm["counters"][
                "decode_steps"],
            "chaos tokens": st["chaos"]["tokens"] == greedy_tokens,
            "chaos report": st["chaos"]["report"] == single["chaos"][
                "report"],
            "crashed and restored": st["chaos"]["report"]["restores"] == 1,
            "insert tokens": st["insert"]["tokens"] == greedy_tokens,
            "insert launches": (
                st["insert"]["inserted"] == len(greedy_tokens)
                and st["insert"]["launches"]
                == L * st["insert"]["decode_steps"]),
        }
        if r < MESH_TP:
            rchecks["1x2 restore tokens"] = (
                st["restore"]["tokens"] == greedy_tokens)
        failed += [f"rank {r} {k}" for k, ok in rchecks.items() if not ok]
        ev = sw["events"]
        rec = cold["events"]["record write"] + wm["events"]["record load"]
        print(f"[chip_smoke] mesh state rank {r} {rank['coord']}: (a) swap "
              f"{sw['wall']:.3f} s, {c['preemptions']} preemptions, "
              f"{c['swap_outs']} swap-outs at "
              f"{[round(e[0], 3) for e in ev['swap-out']]} ms "
              f"({[e[1] for e in ev['swap-out']]} whole bytes), "
              f"{c['swap_ins']} swap-ins at "
              f"{[round(e[0], 3) for e in ev['swap-in']]} ms; "
              f"memory_report {sw['memory']}; (b) cold {cold['wall']:.3f} "
              f"s, flush {cold['flushed']} records in "
              f"{cold['flush_s']:.3f} s (gather and, on the leader, write: "
              f"{len(cold['events']['record write'])} writes here), warm "
              f"{wm['wall']:.3f} s with {wm['counters']['prefix_store_hits']}"
              f" store hits ({len(wm['events']['record load'])} loads, mean "
              f"{np.mean([e[0] for e in rec] or [np.nan]):.3f} ms a record "
              f"op); (c) chaos {st['chaos']['wall']:.3f} s, report "
              f"{st['chaos']['report']}; (d) insert: "
              f"{st['insert']['inserted']} prefixes, decode launches "
              f"{st['insert']['launches']}; state {rank['state_s']:.3f} s")
        if st["restore"] is not None:
            print(f"[chip_smoke] mesh state rank {r}: 1x2 restore of the "
                  f"step-{MESH_RESTORE_STEP} snapshot in "
                  f"{st['restore']['restore_ms']:.3f} ms, then "
                  f"{st['restore']['launches']} decode launches")
    print(f"[chip_smoke] mesh state: {n_store} store files and {n_snaps} "
          f"snapshot files byte-equal to one device's: "
          f"{store_same and snaps_same}; one device warms from the mesh's "
          f"store and restores its snapshot with the mesh's tokens: "
          f"{warmed}, {restored}")
    st = ranks[0]["state"]
    launches = (st["swap"]["launches"] + st["store_cold"]["launches"]
                + st["store_warm"]["launches"] + st["chaos"]["launches"]
                + st["insert"]["launches"] + st["restore"]["launches"])
    return failed, launches


@phase("mesh path")
def mesh_path_phase(torch, cfg, params, plain_reqs):
    """Full-width stablelm-1.6b at cut depth 4 on a 2x2 (data, model) mesh
    of four ranks sharing the card over gloo (weights by CUDA IPC): a
    greedy trace (the main trace's four shortest prompts, 8 new tokens, 4
    slots) through the decode kernel and the same prompts speculatively
    (drafts replaying the greedy tokens, k=4; at depth 4 the n-gram
    drafter's repeated-pattern prompts give no draft on random weights)
    through the verify kernel, then
    the mesh-state scenario (swap, prefix-store warm starts both ways, a
    crash and restore, a 1x2 restore, an insert; ``mesh_state_rank``).  The
    parent serves each on one device while the ranks start.  Every rank
    must give the parent's tokens and bailouts, launch each kernel 4 x its
    forwards of that kind, hold 16 of 32 KV heads, and write records with
    one device's bytes.  Returns (decode launches, verify launches) of one
    rank."""
    import tempfile
    import numpy as np
    from repro_torch.launch.mesh import start_mesh
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    t0 = time.perf_counter()
    cfg, params = cut_model(cfg, params, MESH_DEPTH)
    greedy = sorted((r.prompt for r in plain_reqs), key=len)[:4]
    digest = params_digest(torch, params)
    tmp = tempfile.TemporaryDirectory()
    dirs = {n: f"{tmp.name}/{n}" for n in ("single_store", "mesh_store",
                                           "mesh_snaps", "single_snaps")}
    # The single-device store the mesh warms from, before the spawn.
    cold = PagedEngine(cfg, params, ServeConfig(
        max_slots=1, page_size=16, max_len=512, pool_blocks=STORE_POOL_BLOCKS,
        prefix_store_dir=dirs["single_store"]))
    reqs = [Request(prompt=p.copy(), max_new_tokens=STORE_NEW)
            for p in store_prompts(np, cfg.vocab)]
    cold.generate(reqs)
    cold.flush_prefixes()
    store_cold = [list(r.generated) for r in reqs]
    # The ranks start (spawn, torch import, CUDA context, weights by IPC:
    # about 16 s) while the parent serves the traces on one device.
    job = start_mesh(mesh_rank, MESH_DP, MESH_TP, device="cuda",
                     backend="gloo",
                     args=(cfg, params, greedy, digest, dirs),
                     timeout=600)
    base = ServeConfig(max_slots=4, page_size=16, max_len=512)
    single = {"greedy": mesh_serve(torch, np, PagedEngine(cfg, params, base),
                                   greedy, MESH_NEW_TOKENS)}
    single["replay"] = mesh_serve(torch, np, PagedEngine(
        cfg, params, ServeConfig(max_slots=4, page_size=16, max_len=512,
                                 speculative="draft", draft_k=SPEC_K),
        drafter=replay_of(greedy, single["greedy"]["tokens"])),
        greedy, MESH_NEW_TOKENS)
    state_single = mesh_state_single(torch, np, cfg, params, greedy, dirs)
    ranks = job.join()
    spawned = time.perf_counter() - t0
    L = cfg.n_layers
    for trace in ("greedy", "replay"):
        s = single[trace]
        c = s["counters"]
        print(f"[chip_smoke] mesh path single device, {trace}: "
              f"{sum(map(len, s['tokens']))} tokens in {s['wall']:.3f} s, "
              f"{len(s['tick_ms'])} pure decode ticks at mean "
              f"{np.mean(s['tick_ms'] or [np.nan]):.2f} ms; decode steps "
              f"{c['decode_steps']}, spec ticks {c['spec_ticks']}, "
              f"bailouts {c['spec_bailouts']}")
    failed = []
    for r, rank in enumerate(ranks):
        for trace in ("greedy", "replay"):
            got, want = rank[trace], single[trace]
            c = got["counters"]
            verify_fwd = c["spec_ticks"]
            decode_fwd = c["decode_steps"] - c["spec_ticks"] + \
                c["spec_bailouts"]
            g, coll = got["gather_ms"], got["collective_ms"]
            print(f"[chip_smoke] mesh path rank {r} {rank['coord']}, "
                  f"{trace}: {got['wall']:.3f} s, "
                  f"{len(got['tick_ms'])} pure decode ticks at mean "
                  f"{np.mean(got['tick_ms'] or [np.nan]):.2f} ms; "
                  f"gathers {len(g)} at mean {np.mean(g):.3f} ms per "
                  f"layer (median {np.median(g):.3f}), of which the "
                  f"all_gather {np.mean(coll):.3f} (median "
                  f"{np.median(coll):.3f}); launches decode "
                  f"{got['decode_launches']} = {L} x {decode_fwd}?, verify "
                  f"{got['verify_launches']} = {L} x {verify_fwd}?; "
                  f"bailouts {c['spec_bailouts']}")
            checks = {
                "tokens": got["tokens"] == want["tokens"],
                "bailouts": c["spec_bailouts"] == want["counters"][
                    "spec_bailouts"],
                "decode launches": got["decode_launches"] == L * decode_fwd,
                "verify launches": got["verify_launches"] == L * verify_fwd,
            }
            failed += [f"rank {r} {trace} {k}" for k, ok in checks.items()
                       if not ok]
        if not rank["weights_equal"]:
            failed.append(f"rank {r} weights differ from the parent's")
        if rank["local_kv_heads"] != cfg.n_kv_heads // MESH_TP:
            failed.append(f"rank {r} holds {rank['local_kv_heads']} KV heads")
        if not rank["fused"]:
            failed.append(f"rank {r} did not resolve to the kernels")
    if ranks[0]["replay"]["counters"]["spec_ticks"] == 0:
        failed.append("the replayed trace ran no verify forward")
    if ranks[0]["greedy"]["counters"]["decode_steps"] == 0:
        failed.append("the greedy trace ran no decode tick")
    state_failed, state_launches = mesh_state_report(
        torch, np, cfg, params, ranks, state_single,
        single["greedy"]["tokens"], dirs, store_cold)
    failed += state_failed
    tmp.cleanup()
    if failed:
        raise SystemExit(f"[chip_smoke] mesh path failed: {failed}")
    print(f"[chip_smoke] mesh path (depth {L}): 4 ranks on one card (gloo), "
          f"each with {ranks[0]['local_kv_heads']} of {cfg.n_kv_heads} KV "
          f"heads, weights equal to the parent's, serve the single-device "
          f"tokens and bailouts; launches {L} x forwards on every rank; the "
          f"mesh-state scenario holds; ranks started (beside the parent's "
          f"single-device runs), warmed and served in {spawned:.3f} s "
          f"(warm-up {[round(x['warmup_s'], 3) for x in ranks]} s); phase "
          f"{time.perf_counter() - t0:.3f} s")
    return (ranks[0]["greedy"]["decode_launches"]
            + ranks[0]["replay"]["decode_launches"] + state_launches,
            ranks[0]["replay"]["verify_launches"])


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


def release_shared(torch, params):
    """Free the parent's stablelm weights, which the mesh ranks received by
    CUDA IPC: the caller's name for them is its last reference (the
    engines that held them are cycles, which ``gc.collect`` frees).  A
    process that exits while it still holds tensors it shared makes torch
    warn at exit, after the result lines."""
    params.clear()
    gc.collect()
    torch.cuda.ipc_collect()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="only profile decode ticks, a prefill chunk, "
                         "verify ticks and cache-free forwards (prints no "
                         "result line)")
    ap.add_argument("--mesh", action="store_true",
                    help="only the mesh phases: the shard kernels and the "
                         "2x2 mesh path (prints no result line)")
    ap.add_argument("--train", action="store_true",
                    help="only the baselines and train phases (prints no "
                         "result line)")
    args = ap.parse_args(argv)
    import torch
    name, smi = device_phase(torch)
    if args.train:
        print(smi)
        cfg, params = build_model(torch)
        baselines_phase(torch, cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        train_phase(torch)
        return
    build_phase()
    if args.profile:
        print(smi)
        profile_phase(torch, *build_model(torch))
        return
    if args.mesh:
        import numpy as np
        from repro_torch.serving import Request
        print(smi)
        mesh_kernel_phase(torch)
        cfg, params = build_model(torch)
        mesh_path_phase(torch, cfg, params,
                        make_requests(np, Request, 0, 8, 32, cfg.vocab))
        release_shared(torch, params)
        torch.cuda.empty_cache()
        moe_cfg, moe_params = build_moe_model(torch)
        moe_mesh_phase(torch, moe_cfg, moe_params)
        release_shared(torch, moe_params)
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
    bf16 = bf16_kernel_phase(torch)
    (rows[0]["moe"], rows[1]["moe"], rows[2]["moe"],
     rows[3]["moe"]) = moe_kernel_phase(torch)
    shards = mesh_kernel_phase(torch)
    for row in rows[:2]:
        row["mesh_shards"] = shards[row["name"]]
    for row in rows[:2]:
        main, *pages = bf16[row["name"]]
        row["bf16"] = dict(
            {k: v for k, v in row.items() if k in ("route", "source",
                                                    "replaces")},
            name=f"{row['name']} (bf16 V)", library_ms=None, pages=pages,
            **{k: main[k] for k in ("ms", "f32_ms", "plain_ms", "bound_ms",
                                    "bound_by", "max_abs_err")})
    cfg, params = build_model(torch)
    rows[0]["launches"], plain_reqs, _, f32_main = \
        main_path_phase(torch, cfg, params)
    rows[0]["launches_large_page_engine"] = large_page_engine_phase(
        torch, cfg, params)
    rows[1]["launches"], ngram_prompts = speculative_phase(
        torch, cfg, params, plain_reqs)
    rows[2]["launches"], rows[3]["launches"] = forward_path_phase(
        torch, cfg, params)
    baselines_phase(torch, cfg, params)
    rows[0]["launches_mesh_path"], rows[1]["launches_mesh_path"] = \
        mesh_path_phase(torch, cfg, params, plain_reqs)
    (rows[0]["launches_sampled_path"], rows[1]["launches_sampled_path"],
     recompute_chunks) = sampled_path_phase(torch, cfg, params)
    (rows[0]["launches_chaos_path"],
     rows[1]["launches_chaos_path"]) = chaos_path_phase(
        torch, cfg, params, plain_reqs, ngram_prompts)
    rows[0]["launches_memory_path"] = memory_path_phase(
        torch, cfg, params, recompute_chunks)
    rows[0]["launches_frontdoor_path"] = frontdoor_path_phase(
        torch, cfg, params, plain_reqs)
    dense = dense_path_phase(torch, *cut_model(cfg, params))
    print(f"[chip_smoke] dense path summary: {json.dumps(dense)}")
    rows[0]["bf16"]["launches"], rows[1]["bf16"]["launches"] = \
        bf16_path_phase(torch, cfg, params, f32_main)
    # The model zoo's phases need the card's memory: stablelm goes first.
    del plain_reqs
    release_shared(torch, params)
    torch.cuda.empty_cache()
    moe_cfg, moe_params = build_moe_model(torch)
    (rows[0]["launches_moe_path"], rows[1]["launches_moe_path"],
     rows[2]["launches_moe_forward"],
     rows[3]["launches_moe_forward"]) = moe_path_phase(torch, moe_cfg,
                                                       moe_params)
    gc.collect()
    torch.cuda.empty_cache()
    rows[0]["launches_moe_mesh"], rows[1]["launches_moe_mesh"] = \
        moe_mesh_phase(torch, moe_cfg, moe_params)
    release_shared(torch, moe_params)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_phase(torch)
    train_phase(torch)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

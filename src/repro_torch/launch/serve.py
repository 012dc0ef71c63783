"""Serving launcher: continuous batching with BitStopper (or dense)
attention over a mixed-length request trace.

``python -m repro_torch.launch.serve --arch stablelm-1.6b`` (on the card;
``--device cpu`` runs the plain PyTorch path; ``--engine
paged|continuous|static`` picks the paged engine, the contiguous per-slot
baseline or the static length-bucketed batcher, ``--impl
xla|bitstopper_xla`` the score path; ``--speculative ngram|draft
--draft-k 4`` serves speculatively; ``--temperature 0.7`` samples under
``--seed``; ``--oversubscribe --pool-blocks N`` preempts when the pool runs
dry; ``--swap-host-bytes B`` swaps preemption victims to host RAM;
``--prefix-store-dir DIR`` keeps a persistent prefix store, flushed at the
end, that a later launch warms from; ``--fault-plan '[["crash", 3]]'
--snapshot-dir DIR`` serves through the chaos harness with crash
snapshots).  Mirror of ``repro/launch/serve.py`` for what this port serves
(no ``--mesh``: mesh serving is not ported): the three engines, and on the
paged one deadlines, SLO classes, load shedding, the KV memory hierarchy
and crash recovery, reduced-width configs with seeded random weights.
Flags that only the paged engine takes are refused with the reference's
messages.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving import (ContinuousBatchingEngine, FaultPlan,
                                 PagedEngine, Request, ServeConfig,
                                 StaticBucketEngine, serve_with_chaos)


def make_trace(rng, vocab, n_requests, min_len, max_len, new_tokens,
               shared_prefix=0):
    """Mixed-length request trace; with ``shared_prefix`` > 0 every request
    starts with the same system prompt."""
    prefix = rng.integers(0, vocab, shared_prefix, dtype=np.int32)
    reqs = []
    for _ in range(n_requests):
        tail = rng.integers(0, vocab,
                            int(rng.integers(min_len, max_len + 1)),
                            dtype=np.int32)
        reqs.append(Request(prompt=np.concatenate([prefix, tail]),
                            max_new_tokens=new_tokens))
    return reqs


def main(argv=None):
    """Serve the trace; returns its requests with their tokens."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--impl", default="bitstopper_xla",
                    choices=["xla", "bitstopper_xla"])
    ap.add_argument("--engine", default="paged",
                    choices=["paged", "continuous", "static"])
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common system prompt of this many "
                         "tokens to every request (prefix-sharing demo)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy); tokens are a "
                         "pure function of (--seed, request, token index)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV block (a multiple of 8 for the "
                         "decode kernel and speculative serving)")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="physical KV blocks in the pool (default: full "
                         "capacity for all slots)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens prefilled per scheduler tick")
    ap.add_argument("--oversubscribe", action="store_true",
                    help="admit against context-sized reservations instead "
                         "of worst-case max-new-tokens; mid-decode pool "
                         "exhaustion preempts a victim (freed + requeued; "
                         "resume is lossless, tokens never change)")
    ap.add_argument("--preempt-policy", default="fewest_tokens",
                    choices=["fewest_tokens", "lifo"],
                    help="victim choice under --oversubscribe: least "
                         "generated output (cheapest recompute) or newest "
                         "admission")
    ap.add_argument("--fused-decode", default="auto",
                    choices=["auto", "on", "off"],
                    help="BitStopper decode through the CUDA kernel (on), "
                         "the plain oracle (off), or kernel iff on CUDA "
                         "with a page size that is a multiple of 8")
    ap.add_argument("--speculative", default="off",
                    choices=["off", "ngram", "draft"],
                    help="speculative decoding with the n-gram prompt-lookup "
                         "self-drafter (ngram) or a draft transformer "
                         "(draft; self-drafts with the target model).  "
                         "Lossless: served tokens never change, only how "
                         "many verify forwards they take")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens proposed per speculative tick")
    ap.add_argument("--deadline", type=int, default=None, metavar="TICKS",
                    help="default per-request deadline in scheduler ticks "
                         "from submission; expiry truncates started "
                         "requests (emitted tokens stay a prefix of the "
                         "undisturbed stream) and sheds never-started ones")
    ap.add_argument("--shed-watermark", type=float, default=None,
                    metavar="FRAC",
                    help="shed queued besteffort requests while pool "
                         "saturation exceeds this fraction (requires "
                         "--oversubscribe)")
    ap.add_argument("--besteffort-tail", type=int, default=0, metavar="N",
                    help="mark the last N trace requests slo=besteffort "
                         "(sheddable; preferred preemption victims)")
    ap.add_argument("--swap-host-bytes", type=int, default=0, metavar="B",
                    help="host-RAM budget for swap-to-host preemption: "
                         "victims' exclusive blocks copy to host and resume "
                         "by splice instead of chunked-prefill recompute "
                         "(requires --oversubscribe; 0 = recompute only)")
    ap.add_argument("--prefix-store-dir", default=None,
                    help="persistent prefix store: cold registered prefix "
                         "blocks spill here (atomic stage-then-promote) and "
                         "a restarted engine warms its prefix cache from it")
    ap.add_argument("--prefix-host-bytes", type=int, default=0, metavar="B",
                    help="host-RAM tier between the device prefix LRU and "
                         "the disk store (evictions cascade downward; 0 = "
                         "spill straight to disk)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="persist crash snapshots (engine host state; "
                         "atomic stage-then-promote) under this directory")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                    help="snapshot cadence in engine ticks (with "
                         "--snapshot-dir; 0 = only the initial snapshot)")
    ap.add_argument("--fault-plan", default=None, metavar="PLAN",
                    help="drive the trace through the chaos harness under "
                         "this fault plan: inline JSON [[kind, tick], ...] "
                         "or @file.json.  Crashes need --snapshot-dir to "
                         "restore from")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.speculative != "off" and args.engine != "paged":
        ap.error("--speculative requires --engine paged "
                 "(block-table rollback)")
    if args.oversubscribe and args.engine != "paged":
        ap.error("--oversubscribe requires --engine paged "
                 "(block-pool preemption)")
    if args.engine != "paged" and (
            args.swap_host_bytes or args.prefix_host_bytes
            or args.prefix_store_dir is not None):
        ap.error("--swap-host-bytes/--prefix-store-dir/--prefix-host-bytes "
                 "require --engine paged (docs/serving.md)")
    chaos = args.fault_plan is not None or args.snapshot_dir is not None
    if args.engine != "paged" and (
            chaos or args.deadline is not None
            or args.shed_watermark is not None or args.snapshot_every):
        ap.error("--fault-plan/--snapshot-dir/--snapshot-every/--deadline/"
                 "--shed-watermark require --engine paged "
                 "(docs/robustness.md)")
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch).replace(
        attn_impl=args.impl,
        bitstopper=BitStopperConfig(alpha=args.alpha))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_model(cfg, gen, device)
    scfg = ServeConfig(
        max_len=args.shared_prefix + args.max_prompt + args.new_tokens + 8,
        max_slots=args.slots, temperature=args.temperature,
        page_size=args.page_size, pool_blocks=args.pool_blocks,
        prefill_chunk=args.prefill_chunk,
        fused_decode={"auto": None, "on": True, "off": False}[
            args.fused_decode],
        speculative=args.speculative, draft_k=args.draft_k,
        oversubscribe=args.oversubscribe,
        preempt_policy=args.preempt_policy, deadline_ticks=args.deadline,
        shed_watermark=args.shed_watermark,
        snapshot_every=args.snapshot_every,
        swap_host_bytes=args.swap_host_bytes,
        prefix_store_dir=args.prefix_store_dir,
        prefix_host_bytes=args.prefix_host_bytes)
    plan = None
    if args.fault_plan is not None:
        text = args.fault_plan
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        plan = FaultPlan.from_json(text)

    def make_engine():
        return {"paged": PagedEngine,
                "continuous": ContinuousBatchingEngine,
                "static": StaticBucketEngine}[args.engine](
                    cfg, params, scfg, device=device)

    rng = np.random.default_rng(args.seed)
    reqs = make_trace(rng, cfg.vocab, args.requests, args.min_prompt,
                      args.max_prompt, args.new_tokens,
                      shared_prefix=args.shared_prefix)
    if args.besteffort_tail:
        for r in reqs[len(reqs) - args.besteffort_tail:]:
            r.slo = "besteffort"

    if chaos:
        t0 = time.perf_counter()
        reqs, rep = serve_with_chaos(make_engine, reqs, seed=args.seed,
                                     plan=plan,
                                     snapshot_dir=args.snapshot_dir)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_tok = sum(len(r.generated) for r in reqs)
        c = rep["engine_counters"]
        print(f"[serve] {len(reqs)} requests / {n_tok} new tokens in "
              f"{dt:.2f}s ({n_tok / dt:.1f} tok/s, device={device}, chaos)")
        print(f"[serve] chaos: {rep['crashes']} crashes / "
              f"{rep['restores']} restores, "
              f"{rep['snapshots_taken']} snapshots "
              f"({rep['snapshots_interrupted']} interrupted, "
              f"{rep['staging_reclaimed']} staging orphans reclaimed), "
              f"fired={rep['fired_by_kind']}, unfired={rep['unfired']}")
        print(f"[serve] chaos: {c['degradations']} kernel degradations, "
              f"{c['drafter_failures']} drafter failures, "
              f"{c['forced_preemptions']} forced preemptions, "
              f"{c['requests_shed']} shed (watermark {c['shed_watermark']} "
              f"/ deadline {c['shed_deadline']}), "
              f"{c['deadline_truncated']} deadline-truncated")
        print(f"[serve] counters: {c}")
        return reqs

    engine = make_engine()
    t0 = time.perf_counter()
    engine.generate(reqs, seed=args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.generated) for r in reqs)
    print(f"[serve] {len(reqs)} requests / {n_tok} new tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s, device={device}, engine={args.engine}, "
          f"impl={args.impl}, fused_decode={engine.cfg.fused_decode})")
    if isinstance(engine, StaticBucketEngine):
        return reqs
    print(f"[serve] counters: {engine.counters}")
    if isinstance(engine, ContinuousBatchingEngine):
        print(f"[serve] kv cache: contiguous, resident="
              f"{engine.kv_bytes_resident() / 1024:.1f} KiB")
        return reqs
    if args.speculative != "off":
        c = engine.counters
        acc = (c["spec_accepted"] / c["spec_proposed"]
               if c["spec_proposed"] else 0.0)
        print(f"[serve] speculative({args.speculative}, k={args.draft_k}): "
              f"{c['spec_ticks']} verify ticks, "
              f"{c['spec_accepted']}/{c['spec_proposed']} drafts accepted "
              f"({acc:.0%}), {c['spec_bailouts']} scale-growth bailouts, "
              f"{c['decode_tokens']}/{c['decode_steps']} tokens/tick")
    if args.oversubscribe:
        c = engine.counters
        print(f"[serve] oversubscribed({args.preempt_policy}): "
              f"{c['preemptions']} preemptions, "
              f"{c['preempt_freed_blocks']} blocks reclaimed, "
              f"{c['preempt_dropped_tokens']} cached tokens dropped "
              f"(resume re-maps registered blocks, recomputes the "
              f"unshared tail)")
    if args.deadline is not None or args.shed_watermark is not None:
        c = engine.counters
        print(f"[serve] qos: {c['requests_shed']} shed (watermark "
              f"{c['shed_watermark']} / deadline {c['shed_deadline']}), "
              f"{c['deadline_truncated']} deadline-truncated")
    if (args.swap_host_bytes or args.prefix_host_bytes
            or args.prefix_store_dir is not None):
        if args.prefix_store_dir is not None:
            # Graceful shutdown: persist the registered prefix blocks, so
            # that the next launch warms from the store.
            flushed = engine.flush_prefixes()
            print(f"[serve] prefix store: flushed {flushed} record(s) to "
                  f"{args.prefix_store_dir}")
        c = engine.counters
        print(f"[serve] hierarchy: {c['swap_outs']} swap-outs / "
              f"{c['swap_ins']} swap-ins ({c['swap_in_tokens']} tokens "
              f"spliced, {c['swap_fallbacks']} recompute fallbacks), "
              f"{c['prefix_spills']} prefix spills, "
              f"{c['prefix_store_hits']} store hits "
              f"({c['prefix_store_tokens']} tokens warmed); "
              f"tiers={engine.memory_report()}")
    print(f"[serve] kv pool: page_size={engine.layout.page_size} "
          f"blocks={engine.layout.pool_blocks} "
          f"peak_live={engine.pool.peak_live_blocks} "
          f"resident={engine.kv_bytes_resident() / 1024:.1f} KiB")
    return reqs


if __name__ == "__main__":
    main()

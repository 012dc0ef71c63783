#!/usr/bin/env python3
"""The main path on f32 and bf16 KV caches, on one CUDA card, in turns.

``python3 compare_cache_dtype.py`` from the root of a checkout (a
development script beside ``chip_smoke.py``).  It builds full-width
``stablelm-1.6b`` as the smoke does and serves the smoke's main trace
through ``PagedEngine`` (``bitstopper_xla``, the decode kernel) with
``cache_dtype`` float32, bfloat16, bfloat16, float32, printing tokens/s
and the mean pure decode, pure prefill and mixed tick of each run (host
clock, synchronised), then ``torch.profiler`` over 8 decode ticks at each
dtype (device time by kernel, busy share).  Host speed drifts between
calls and within one, so only these runs in turns compare the two dtypes.
"""

from __future__ import annotations

import sys
from pathlib import Path


def main() -> None:
    import numpy as np
    import torch
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import PagedEngine, Request, ServeConfig

    name, smi = cs.device_phase(torch)
    cs.build_phase()
    print(f"[compare] {smi}")
    cfg, params = cs.build_model(torch)
    scfg = {dt: ServeConfig(max_slots=4, page_size=16, max_len=512,
                            cache_dtype=dt)
            for dt in ("float32", "bfloat16")}
    PagedEngine(cfg, params, scfg["float32"]).generate(
        cs.make_requests(np, Request, 99, 1, 2, cfg.vocab))   # warm-up
    runs = {"float32": [], "bfloat16": []}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        eng = PagedEngine(cfg, params, scfg[dt])
        runs[dt].append(cs.serve_main_trace(
            torch, np, eng, cfg.vocab, f"compare {dt}", "prefill_chunks"))
    same = sum(a == b for a, b in zip(runs["float32"][0]["tokens"],
                                      runs["bfloat16"][0]["tokens"]))
    for dt, rs in runs.items():
        print(f"[compare] {dt}: tok/s {[round(r['tok_s'], 2) for r in rs]}, "
              f"pure decode tick ms {[round(r['decode_ms'], 2) for r in rs]}"
              f", pure prefill ms {[round(r['prefill_ms'], 2) for r in rs]}, "
              f"mixed ms {[round(r['mixed_ms'], 2) for r in rs]}")
    print(f"[compare] {same} of 8 requests give the same tokens at both "
          f"dtypes")
    for dt in ("float32", "bfloat16"):
        eng = PagedEngine(cfg, params, scfg[dt])
        for r in cs.make_requests(np, Request, 0, 4, 48, cfg.vocab):
            eng.submit(r)
        while eng._prefill_fifo or not eng.counters["decode_steps"]:
            eng.step()
        cs.report_profile(torch, ProfilerActivity, profile,
                          f"decode tick, {dt} cache", eng.step, 8)


if __name__ == "__main__":
    main()

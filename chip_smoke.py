#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

``python3 chip_smoke.py`` from the root of a checkout.  It builds the
port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` (into
``build/``), then:

1. device: requires CUDA, prints the card and its power limit, turns TF32
   off for matmuls and convolutions;
2. kernels: runs every kernel of the main path against its plain PyTorch
   version at the main path's shapes (integer observables exactly equal,
   float output within a stated tolerance) and times both;
3. main path: serves greedy requests with full-width ``stablelm-1.6b``
   (seeded random weights) through ``repro_torch.serving.PagedEngine``,
   checks that every decode tick launched the kernel once per layer, and
   that a short trace gives the same tokens with the kernel and with the
   plain oracle;
4. prints one JSON line describing each kernel, then the device line last.

Any failed check exits non-zero.  Without a card it exits non-zero and
prints no result.
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
OUT_TOL = 1e-5                   # kernel vs plain output: expf and the sum
                                 # order differ, integers are exact
L2_FLUSH_BYTES = 128 * 2**20     # written before each timed call (L2: 50 MB)


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


def decode_case(torch, seed, B, Hq, Hkv, D, bs, MB, P, bits=12,
                dev="cuda"):
    """A pool and block tables with mixed fill levels, a prefix page shared
    by two slots, an inactive slot and recycled pages holding stale data."""
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
    lengths = np.array([MB * bs - 12, 7 * bs + 3, 0, 77][:B], np.int32)
    table = np.zeros((B, MB), np.int32)
    used = 0
    for b in range(B):
        n = -(-int(lengths[b]) // bs)
        table[b, :n] = perm[used:used + n]
        used += n
    table[1, :3] = table[0, :3]                    # shared prefix pages
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    q[:, :, :] += hot[0].repeat(Hq // Hkv, axis=0)[None] * 0.5
    k_amax = np.abs(k).max(axis=(0, 1, 3)) * 1.25
    v_amax = np.abs(v).max(axis=(0, 1, 3)) * 1.25
    t = lambda a: torch.as_tensor(a, device=dev)
    kt = t(k)
    kq = qlib.pack_pool_planes(kt, t(k_amax), bits)
    q_pos = np.maximum(lengths - 1, 0).astype(np.int32)
    return (t(q), kq, t(v), t(table), t(lengths), t(q_pos), t(k_amax),
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

    # Time the serving shape (stats=False) on the first case.
    cfg = BitStopperConfig(alpha=0.6)
    args = decode_case(torch, 100, Hkv=32, **shapes)
    _, rounds_h, surv = pd.launch_kernel(*args, cfg=cfg, stats=True)
    nbytes, ops = decode_bytes_ops(args, rounds_h, surv, stats=False)
    ms = cuda_ms(torch, lambda: pd.paged_bitstopper_decode(
        *args, cfg=cfg, stats=False), iters=50, warmup=5)
    plain_ms = cuda_ms(torch, lambda: pd.paged_bitstopper_decode_plain(
        *args, cfg=cfg, stats=False), iters=3, warmup=1)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / INT8_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    print(f"[chip_smoke] paged_decode timing (B=4, H=32, D=64, bs=16, "
          f"MB=32): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.5f} ms ({nbytes} bytes, {ops} ops)")
    return {"name": "paged_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_decode.py:314",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None}


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


@phase("main path")
def main_path_phase(torch):
    """Full-width stablelm-1.6b served greedily through the port's
    PagedEngine; returns the kernel launch count of the main run."""
    import numpy as np
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serving import PagedEngine, Request, ServeConfig

    cfg, params = build_model(torch)
    scfg = ServeConfig(max_slots=4, page_size=16, max_len=512)

    # Warm-up (cuBLAS handles, allocator) on a throwaway engine.
    PagedEngine(cfg, params, scfg).generate(
        make_requests(np, Request, 99, 1, 2, cfg.vocab))
    torch.cuda.synchronize()

    eng = PagedEngine(cfg, params, scfg)
    if not eng.cfg.fused_decode:
        raise SystemExit("[chip_smoke] fused_decode did not resolve to the "
                         "kernel on the card")
    kernel_events = []
    real_launch = pd.launch_c

    def timed_launch(*a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real_launch(*a)
        end.record()
        kernel_events.append((start, end))

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
    pd.launch_c = timed_launch
    pd.LAUNCHES = 0
    t = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = pd.LAUNCHES
    pd.launch_c = real_launch
    qlib.pack_pool_planes = real_pack
    ticks = eng.counters["decode_steps"]
    n_tok = sum(len(r.generated) for r in reqs)
    kernel_ms = sum(s.elapsed_time(e) for s, e in kernel_events)
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
    return launches


@phase("profile")
def profile_phase(torch, decode_ticks=8):
    """torch.profiler over steady decode ticks and one prefill chunk of the
    main path: device time by kernel, and the device's busy share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import PagedEngine, Request, ServeConfig
    cfg, params = build_model(torch)
    scfg = ServeConfig(max_slots=4, page_size=16, max_len=512)
    eng = PagedEngine(cfg, params, scfg)
    for r in make_requests(np, Request, 0, 4, 48, cfg.vocab):
        eng.submit(r)
    eng.step()                      # admit all four, first prefill chunk
    torch.cuda.synchronize()
    report_profile(torch, ProfilerActivity, profile, "prefill chunk",
                   eng._prefill_tick, 1)
    while eng._prefill_fifo:
        eng.step()
    report_profile(torch, ProfilerActivity, profile, "decode tick",
                   eng.step, decode_ticks)


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
                    help="only profile decode ticks and a prefill chunk of "
                         "the main path (prints no result line)")
    args = ap.parse_args(argv)
    import torch
    name, smi = device_phase(torch)
    if args.profile:
        print(smi)
        profile_phase(torch)
        return
    row = kernel_phase(torch)
    row["launches"] = main_path_phase(torch)
    print(smi)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

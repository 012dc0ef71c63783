#!/usr/bin/env python3
"""The paged kernels, ``bitstopper_qk`` and ``flash_attention`` of this
checkout against another version of them, on one CUDA card, in turns.

``python3 compare_paged.py OTHER_CSRC`` from the root of a checkout (a
development script beside ``chip_smoke.py``).  OTHER_CSRC holds another
``paged_decode.cu``, ``paged_verify.cu``, ``bitstopper_qk.cu`` and
``flash_attention.cu`` with the same C entry points (for example
``src/repro_torch/kernels/csrc`` of a
parent commit unpacked with ``git archive`` under the git-ignored
``build/``).  It builds them with the port's flags into ``build/compare/``
beside this checkout's, and at ``chip_smoke.py``'s kernel shapes it:

* paged kernels (B=4, 32 heads, D=64, bs=16, MB=32, alpha 0.6; the verify
  with Sq=5 draft blocks): checks that the two versions give the same
  bits (out, per-KV-head rounds and survivors) and times each alone on
  operands prepared once (``stats`` off, as served), 50 launches;
* ``bitstopper_qk`` (N=64 slices, S=1024, d=64, blocks 128, alpha 0.6, on
  the hot and the unpruned inputs, causal and not): checks that rounds
  and survivors are identical, counts the out elements that differ and
  the largest difference, and times each alone (causal, as the forward
  runs it), 10 launches;
* ``flash_attention`` (the same shape, blocks 128, causal and not): the
  largest difference between the two versions' out and each version's
  largest difference from the plain version (both must stay within
  ``chip_smoke.UNCACHED_TOL``), and each alone (causal), 10 launches;

each timing with a cold L2, in the order other, this, this, other.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

KERNELS = ("paged_decode", "paged_verify", "bitstopper_qk",
           "flash_attention")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path,
                    help="directory with the other paged_decode.cu, "
                         "paged_verify.cu, bitstopper_qk.cu and "
                         "flash_attention.cu")
    args = ap.parse_args(argv)
    import torch
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import bitstopper_qk as bq
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.kernels import runtime

    if not torch.cuda.is_available():
        raise SystemExit("the comparison needs a CUDA card")
    out_dir = root / "build" / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    other_libs = {name: out_dir / f"lib{name}_other.so" for name in KERNELS}
    builds = [subprocess.Popen([runtime.nvcc_path(), *runtime.NVCC_FLAGS,
                                "-o", str(other_libs[name]),
                                str(args.other / f"{name}.cu")])
              for name in KERNELS]
    runtime.build_libraries(KERNELS)
    if any(p.wait() for p in builds):
        raise SystemExit("building the other kernels failed")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[compare] {smi}; other: {args.other}")

    cfg = BitStopperConfig(alpha=0.6)
    shapes = dict(B=4, Hq=32, Hkv=32, D=64, bs=16, MB=32, P=129)
    failed = []
    for name, mod, Sq, seed in (("paged_decode", pd, 1, 100),
                                ("paged_verify", pv, cs.SPEC_K + 1, 200)):
        case = cs.decode_case(torch, seed, Sq=Sq, **shapes)
        fns = {"other": mod.entry_point(ctypes.CDLL(str(other_libs[name]))),
               "this": mod.entry_point(runtime.load_library(name))}
        got = {}
        for who, fn in fns.items():
            kargs, _keep, out, rounds_h, surv = mod.kernel_args(*case,
                                                                cfg=cfg)
            if fn(*kargs) != 0:
                raise SystemExit(f"{name} ({who}) failed to launch")
            torch.cuda.synchronize()
            got[who] = (out, rounds_h, surv)
        same = all(torch.equal(a, b)
                   for a, b in zip(got["other"], got["this"]))
        if not same:
            failed.append(name)
        kargs, _keep, *_ = mod.kernel_args(*case, cfg=cfg, stats=False)
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            times[who].append(cs.cuda_ms(
                torch, lambda: fns[who](*kargs), iters=50, warmup=5))
        print(f"[compare] {name} (Sq={Sq}): out, rounds and survivors "
              f"{'bit-identical' if same else 'DIFFER'}; kernel alone ms: "
              f"other {times['other'][0]:.4f} and {times['other'][1]:.4f}, "
              f"this {times['this'][0]:.4f} and {times['this'][1]:.4f}; "
              f"this / other {sum(times['this']) / sum(times['other']):.3f}")

    fns = {"other": bq.entry_point(ctypes.CDLL(str(
        other_libs["bitstopper_qk"]))),
           "this": bq.entry_point(runtime.load_library("bitstopper_qk"))}
    for label, seed, hot in (("hot", 300, True), ("unpruned", 302, False)):
        q, k, v = cs.uncached_case(torch, seed, hot=hot)
        blk = min(128, q.shape[1])
        ops = bq.prep(q, k, v, cfg)
        for causal in (False, True):
            got = {}
            for who, fn in fns.items():
                kargs, res = bq.kernel_args(ops, cfg, blk, blk, causal)
                if fn(*kargs) != 0:
                    raise SystemExit(f"bitstopper_qk ({who}) failed to "
                                     f"launch")
                torch.cuda.synchronize()
                got[who] = res
            a, b = got["other"], got["this"]
            same = (torch.equal(a.rounds, b.rounds)
                    and torch.equal(a.survivors, b.survivors))
            if not same:
                failed.append(f"bitstopper_qk {label} causal={causal}")
            diff = (a.out - b.out).abs()
            print(f"[compare] bitstopper_qk {label} causal={causal}: rounds "
                  f"and survivors {'identical' if same else 'DIFFER'}; out "
                  f"differs in {int((diff > 0).sum())} of {diff.numel()} "
                  f"elements, max |diff| {float(diff.max()):.3e}")
        kargs, _res = bq.kernel_args(ops, cfg, blk, blk, True)
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            times[who].append(cs.cuda_ms(
                torch, lambda: fns[who](*kargs), iters=10, warmup=2))
        print(f"[compare] bitstopper_qk {label} causal (N={q.shape[0]}, "
              f"S={q.shape[1]}): kernel alone ms: other "
              f"{times['other'][0]:.4f} and {times['other'][1]:.4f}, this "
              f"{times['this'][0]:.4f} and {times['this'][1]:.4f}; this / "
              f"other {sum(times['this']) / sum(times['other']):.3f}")

    fns = {}
    for who, lib in (("other", ctypes.CDLL(str(other_libs[
            "flash_attention"]))),
                     ("this", runtime.load_library("flash_attention"))):
        fns[who] = lib.flash_attention_launch
        fns[who].argtypes = fa._ARGTYPES
        fns[who].restype = ctypes.c_int
    q, k, v = cs.uncached_case(torch, 301)
    N, S, d = q.shape
    blk = min(128, S)
    stream = torch.cuda.current_stream().cuda_stream

    def flash(fn, out, causal):
        if fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), N, S,
              S, d, d, blk, blk, int(causal), 1.0 / d ** 0.5, stream) != 0:
            raise SystemExit("flash_attention failed to launch")

    for causal in (False, True):
        got = {}
        for who, fn in fns.items():
            got[who] = torch.empty_like(q)
            flash(fn, got[who], causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = {who: float((o - want).abs().max()) for who, o in got.items()}
        if max(err.values()) > cs.UNCACHED_TOL:
            failed.append(f"flash_attention causal={causal} vs plain")
        print(f"[compare] flash_attention causal={causal}: max|this - "
              f"other| {float((got['this'] - got['other']).abs().max()):.3e};"
              f" max|out - plain| other {err['other']:.3e}, this "
              f"{err['this']:.3e} (limit {cs.UNCACHED_TOL:g})")
    out = torch.empty_like(q)
    times = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        times[who].append(cs.cuda_ms(
            torch, lambda: flash(fns[who], out, True), iters=10, warmup=2))
    print(f"[compare] flash_attention causal (N={N}, S={S}, d={d}): kernel "
          f"alone ms: other {times['other'][0]:.4f} and "
          f"{times['other'][1]:.4f}, this {times['this'][0]:.4f} and "
          f"{times['this'][1]:.4f}; this / other "
          f"{sum(times['this']) / sum(times['other']):.3f}")
    if failed:
        raise SystemExit(f"[compare] checks failed: {failed}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where a tile of the bitstopper_qk kernel goes, in clock cycles.

``python3 probe_qk.py`` on a CUDA card, from the root of a checkout (a
development script beside ``chip_smoke.py``).  It builds
``src/repro_torch/kernels/csrc/bitstopper_qk.cu`` with the port's flags and
``-DBITSTOPPER_QK_PROBE`` into ``build/probe/``: the source's
``PROBE_STAMP`` points then add each stretch of block 0's loop over kv
blocks (the heaviest causal q tile of slice 0, eight kv blocks) into
counters, read back after the launch.  Lane 0 of warp 0 and lane 0 of the
last warp each count: the wait for a plane, the plane dots (with the rows'
largest live partials), LATS, the liveness vote, the block's bookkeeping
(plane requests, survivors, set-up), the softmax with V's request, the
wait for V and P x V.  The build is checked against the plain version
(rounds and survivors exact) at ``chip_smoke.py``'s qk shape (N=64 slices,
S=1024, d=64, blocks 128, alpha 0.6, causal), on the hot and the unpruned
inputs.  Two warps share an SM sub-partition, so a warp's stretch also
holds the other warp's issue; a round's sum over its stretches is the
round's time.  The stamps cost a few percent; the per-launch time printed
beside them is of the stamped build.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

STRETCHES = ("wait for plane", "plane dots", "LATS", "vote",
             "bookkeeping", "softmax", "wait for V", "P x V")


def main() -> None:
    import torch
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import bitstopper_qk as bq
    from repro_torch.kernels import runtime

    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA card")
    out = root / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libbitstopper_qk_probe.so"
    subprocess.run([runtime.nvcc_path(), *runtime.NVCC_FLAGS,
                    "-DBITSTOPPER_QK_PROBE", "-o", str(lib_path),
                    str(runtime.CSRC / "bitstopper_qk.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    launch = bq.entry_point(lib)
    read = lib.bitstopper_qk_probe_read
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[probe] {smi}")
    cfg = BitStopperConfig(alpha=0.6)
    for label, seed, hot in (("hot", 300, True), ("unpruned", 302, False)):
        q, k, v = cs.uncached_case(torch, seed, hot=hot)
        blk = min(128, q.shape[1])
        ops = bq.prep(q, k, v, cfg)
        kargs, res = bq.kernel_args(ops, cfg, blk, blk, True)
        if launch(*kargs) != 0:
            raise SystemExit("probe launch failed")
        ref = bq.bitstopper_qk_plain(ops, cfg, blk, blk, True)
        if not (torch.equal(res.rounds, ref.rounds)
                and torch.equal(res.survivors, ref.survivors)):
            raise SystemExit("stamped kernel differs from the plain version")
        for _ in range(2):
            launch(*kargs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            launch(*kargs)
        end.record()
        torch.cuda.synchronize()
        c = (ctypes.c_longlong * 20)()
        if read(c) != 0:
            raise SystemExit("reading the probe's counters failed")
        rounds, tiles = max(c[18], 1), max(c[19], 1)
        print(f"[probe] {label}: {start.elapsed_time(end) / 10:.4f} ms per "
              f"launch (warm L2); block 0 runs {c[18]} live rounds and "
              f"{c[19]} surviving tiles in {c[16]} cycles (warp 0) and "
              f"{c[17]} (last warp)")
        for name, o in (("warp 0", 0), ("last warp", 8)):
            per_round = ", ".join(f"{STRETCHES[j]} {c[o + j] / rounds:.0f}"
                                  for j in range(5))
            per_tile = ", ".join(f"{STRETCHES[j]} {c[o + j] / tiles:.0f}"
                                 for j in range(5, 8))
            print(f"[probe]   {name}: cycles a round: {per_round}; "
                  f"cycles a surviving tile: {per_tile}")


if __name__ == "__main__":
    main()

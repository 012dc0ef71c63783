#!/usr/bin/env python3
"""Where a page of the paged_decode kernel's walk goes, in clock cycles.

``python3 probe_decode.py`` on a CUDA card, from the root of a checkout (a
development script beside ``chip_smoke.py``).  It builds
``src/repro_torch/kernels/csrc/paged_decode.cu`` with the port's flags and
``-DPAGED_DECODE_PROBE`` into ``build/probe/``: the source's
``PROBE_STAMP`` points then add each stretch of block (0, 0)'s loop over
pages into counters, read back after the launch.  Lane 0 of the first walk
warp counts the page barrier with the wait for the page's planes, the
plane dots and the LATS passes; lane 0 of the first epilogue warp counts
the page barrier, the verdict with the plane and V requests, the wait for
V, V's quantization and the softmax with S x V.  The build is checked
against the plain version (rounds and survivors exact) on the kernel
phase's shape of ``chip_smoke.py`` (B=4, 32 heads, D=64, bs=16, MB=32; slot
0 walks 32 pages), and launched with alpha 0.6 (LATS prunes) and 1000
(nothing pruned).  The stamps cost a few percent; the per-launch time
printed beside them is of the stamped build.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

WALK = ("page barrier and wait for planes", "plane dots", "LATS passes")
EPILOGUE = ("page barrier", "verdict, plane and V requests", "wait for V",
            "quantize V", "softmax and S x V")


def main() -> None:
    import torch
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.core.besf import BitStopperConfig
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import runtime

    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA card")
    out = root / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libpaged_decode_probe.so"
    subprocess.run([runtime.nvcc_path(), *runtime.NVCC_FLAGS,
                    "-DPAGED_DECODE_PROBE", "-o", str(lib_path),
                    str(runtime.CSRC / "paged_decode.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    launch = pd.entry_point(lib)
    read = lib.paged_decode_probe_read
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[probe] {smi}")
    for alpha in (0.6, 1000.0):
        cfg = BitStopperConfig(alpha=alpha)
        args = cs.decode_case(torch, 100, B=4, Hq=32, Hkv=32, D=64, bs=16,
                              MB=32, P=129)
        kargs, _keep, _, rounds_h, surv = pd.kernel_args(*args, cfg=cfg)
        if launch(*kargs) != 0:
            raise SystemExit("probe launch failed")
        ref = pd.paged_bitstopper_decode_plain(*args, cfg=cfg)
        if not (torch.equal(rounds_h.amax(1), ref.rounds)
                and torch.equal(surv.bool(), ref.survivors)):
            raise SystemExit("stamped kernel differs from the plain version")
        for _ in range(3):
            launch(*kargs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            launch(*kargs)
        end.record()
        torch.cuda.synchronize()
        c = (ctypes.c_longlong * 19)()
        if read(c) != 0:
            raise SystemExit("reading the probe's counters failed")
        pages = max(c[18], 1)
        walk = ", ".join(f"{n} {c[k] / pages:.0f}"
                         for k, n in enumerate(WALK))
        epi = ", ".join(f"{n} {c[11 + k] / pages:.0f}"
                        for k, n in enumerate(EPILOGUE))
        print(f"[probe] alpha {alpha}: {start.elapsed_time(end) / 20:.4f} "
              f"ms per launch (warm L2), block (0, 0) walks {c[18]} pages "
              f"in {c[16]} cycles ({c[16] / pages:.0f} a page)")
        print(f"[probe]   walk warp, cycles a page: {walk}")
        print(f"[probe]   epilogue warp, cycles a page: {epi}")


if __name__ == "__main__":
    main()

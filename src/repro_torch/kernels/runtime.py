"""Device and toolchain resolution for the port's kernels.

Counterpart of ``repro/kernels/runtime.py``, whose ``resolve_interpret``
chose between compiled and interpreted Pallas.  Here the choice is made by
the tensors: a kernel wrapper launches its CUDA kernel for CUDA tensors and
runs its plain version for CPU tensors.  Nothing falls back silently: a
missing card, a missing ``nvcc`` or a failed build raises.

Kernels are compiled at first use with ``nvcc`` into a shared library with
a plain C interface (loaded through ``ctypes``), under ``build/kernels/`` at
the root of the checkout, keyed by a hash of the source, the headers in
``csrc/`` and the flags.  There are four kernels: ``paged_decode`` and
``paged_verify`` (the serving reads, which share their page walk through
``csrc/paged_walk.cuh``), ``bitstopper_qk`` and ``flash_attention`` (the
cache-free forward).  Each builds into a library of its name; the two
paged kernels also into ``<name>_bf16``, their form for a bf16 V pool
(the same source with ``-DPAGED_V_BF16``), so that the two forms compile
side by side.  The widths the two cache-free kernels take are one rule,
``width_refusal``, which both wrappers apply and both C entry points
state.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# sm_90a keeps Hopper-only instructions available to later kernels.  No
# --use_fast_math and no FMA contraction: the LATS bounds must round
# exactly like the plain version's separate IEEE adds and multiplies.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}

# Libraries built from another source: name -> (source, extra flags).
_VARIANTS = {f"{k}_bf16": (k, ("-DPAGED_V_BF16",))
             for k in ("paged_decode", "paged_verify")}

MAX_HEAD = 160              # widest head of any width (wider ones must be
                            # a multiple of 16)
MAX_WIDTH = 256             # widest head and value width


def width_refusal(D: int, Dv: int) -> str | None:
    """Why the cache-free kernels (flash and ``bitstopper_qk``) refuse a
    head width D and value width Dv, or None: they take any head width up to
    160, wider ones that are a multiple of 16 up to 256, and value widths
    that are a multiple of 16 up to 256."""
    if Dv % 16 or not 16 <= Dv <= MAX_WIDTH or not 1 <= D <= MAX_WIDTH or \
            (D > MAX_HEAD and D % 16):
        return (f"value widths that are a multiple of 16 up to {MAX_WIDTH} "
                f"and head widths up to {MAX_HEAD}, or multiples of 16 up to "
                f"{MAX_WIDTH}, got D={D}, Dv={Dv}")
    return None


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raise if there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_card(*tensors: torch.Tensor) -> bool:
    """True iff every tensor lies on one CUDA device, False iff all lie on
    the CPU; mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel operands on mixed or unsupported devices "
                     f"{sorted(kinds)}")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source of library ``name`` and the flags it adds."""
    src, extra = _VARIANTS.get(name, (name, ()))
    return CSRC / f"{src}.cu", extra


def _library_path(name: str) -> Path:
    """Where library ``name`` is built: named by a hash of its source, of
    every header in ``csrc/`` (a source may include any of them) and of the
    flags, so that editing a shared header rebuilds its kernels."""
    src, extra = _source(name)
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + extra).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_libraries(names) -> None:
    """Build every library of ``names`` not built yet, one ``nvcc`` per
    library, all started together, and load them."""
    jobs = []
    for name in names:
        out = _library_path(name)
        if name in _LIBS or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src, extra = _source(name)
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", tmp, str(src)]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}:\n{err}")
        else:
            os.replace(tmp, out)        # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        load_library(name)


def loaded_library(name: str) -> ctypes.CDLL | None:
    """Library ``name`` if this process has loaded it, else None."""
    return _LIBS.get(name)


def load_library(name: str) -> ctypes.CDLL:
    """Build library ``name`` (once per content hash) and load it."""
    if name in _LIBS:
        return _LIBS[name]
    out = _library_path(name)
    if not out.exists():
        build_libraries([name])
    _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]

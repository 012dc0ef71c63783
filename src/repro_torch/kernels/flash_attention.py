"""Dense flash attention: the uncached forward's ``attn_impl="flash"`` path.

Counterpart of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel
``flash_attention_single``).  Three pieces live here:

* :func:`flash_attention_single` with the reference's signature and block
  clamps, and :func:`flash_attention`, the same over leading batch dims in
  one launch (the reference ``vmap``s the single form).  CUDA tensors go
  through the hand-written kernel ``csrc/flash_attention.cu`` (split-TF32
  tensor cores up to head width 160, a CUDA-core form beyond, up to 256),
  CPU tensors through the plain version.  A failed build or launch raises;
  there is no fallback.
* :func:`flash_attention_plain`, the dense masked softmax of
  ``kernels/ref.py``, which the kernel's online softmax equals up to the
  order of its sums.
* ``LAUNCHES``, the number of kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.runtime import (load_library, on_card,
                                         width_refusal)

LAUNCHES = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.c_void_p])
MAX_BLOCK = 128             # largest q or kv tile the kernel takes


def _blocks(q, k, block_q: int, block_k: int) -> tuple[int, int]:
    """The reference's clamps ``min(block, S)`` and its divisibility check
    (an assertion there, ``ValueError`` here)."""
    Sq, Sk = q.shape[-2], k.shape[-2]
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"sequence lengths ({Sq}, {Sk}) are not tiled by "
                         f"blocks ({bq}, {bk})")
    return bq, bk


def flash_attention_plain(q, k, v, causal: bool = False,
                          sm_scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain torch: dense masked softmax."""
    return ref.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


def launch_kernel(q, k, v, causal: bool, sm_scale: float, bq: int,
                  bk: int) -> torch.Tensor:
    """One launch over q [N, Sq, D], k [N, Sk, D], v [N, Sk, Dv] on the
    card; returns f32 [N, Sq, Dv].  Heads up to 160 with a value width of
    16, 32, 64, 128 or 160 run the tensor-core form, every other width the
    CUDA-core form (the source chooses)."""
    N, Sq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[2]
    if k.shape != (N, Sk, D) or v.shape[:2] != (N, Sk):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    reason = width_refusal(D, Dv)
    if reason is not None or bq > MAX_BLOCK or bk > MAX_BLOCK:
        raise ValueError(f"the flash kernel takes {reason or 'these widths'}"
                         f" and blocks up to {MAX_BLOCK}, got blocks ({bq}, "
                         f"{bk})")
    qf, kf, vf = (x.float().contiguous() for x in (q, k, v))
    out = torch.empty((N, Sq, Dv), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        launch_c(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
                 N, Sq, Sk, D, Dv, bq, bk, int(causal), sm_scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    return out


def launch_c(*args) -> None:
    """The C entry point ``flash_attention_launch`` (argument order of
    ``csrc/flash_attention.cu``); raises on a launch error and counts the
    launch."""
    global LAUNCHES
    fn = load_library("flash_attention").flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: float | None = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Flash attention over q [..., Sq, d], k [..., Sk, d], v [..., Sk, dv]:
    every leading index is one slice, and all slices go in one launch.
    Returns ``q.dtype``."""
    bq, bk = _blocks(q, k, block_q, block_k)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if not on_card(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
    flat = lambda x: x.reshape((-1,) + x.shape[-2:])
    out = launch_kernel(flat(q), flat(k), flat(v), causal, sm_scale, bq, bk)
    return out.reshape(q.shape[:-2] + out.shape[1:]).to(q.dtype)


def flash_attention_single(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = False,
                           sm_scale: float | None = None, block_q: int = 128,
                           block_k: int = 128) -> torch.Tensor:
    """q [Sq, d], k [Sk, d], v [Sk, dv] -> [Sq, dv] (the reference's
    signature, without ``interpret``)."""
    if q.ndim != 2:
        raise ValueError(f"flash_attention_single takes [S, d] operands, "
                         f"got q {tuple(q.shape)}")
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                           block_q=block_q, block_k=block_k)

"""Fused paged BESF decode: the serving decode's per-token hot path.

Counterpart of ``repro/kernels/paged_decode.py`` (the Pallas TPU kernel
``paged_bitstopper_decode``).  Three pieces live here:

* :func:`paged_bitstopper_decode`, the wrapper with the reference's
  signature.  It prepares the operands in torch (``paged_decode_prep``, as
  the reference does outside ``pallas_call``), then launches the CUDA kernel
  ``csrc/paged_decode.cu`` for CUDA tensors, or runs the plain version for
  CPU tensors.  A failed build or launch raises; there is no fallback.
* :func:`paged_bitstopper_decode_plain`, the same function in plain torch
  over the packed ``kq`` pool: unpack a page's planes, then the oracle's
  page walk op for op.
* ``LAUNCHES``, the number of kernel launches, so a run can show that its
  decode went through the kernel, and :func:`copied_bytes`, the plane and
  V bytes the kernel requested, so a run measures what it copied.

The kernel runs one thread block per (slot, KV head).  Walk warps, one
per query head, run the LATS rounds on planes already in shared memory
(all planes of a page, copied two pages ahead) and synchronise only within
the warp; epilogue warps copy V for pages with a survivor and run the
softmax one page behind.  Pages of more than 256 tokens (up to
``MAX_PAGE``) run a kernel of their own, the striped walk of
``csrc/paged_walk.cuh``: round by round over 32-token stripes with each
row's partials in shared memory, so that LATS still decides per page, and
V staged 64 tokens at a time.  What bounds it is the latency of one slot's
serial page walk, with B x Hkv blocks in the grid (128 at B=4).  Plane
counts are per query head: a KV head's is their max, and the slot-wide
``rounds`` of the reference is the max over KV heads
(``tests/test_torch_paged_decode.py`` proves both rules on the plain
version).  The walk and epilogue live in ``csrc/paged_walk.cuh``, which
``csrc/paged_verify.cu`` runs too: every real verify query equals this
kernel at its position bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.besf import (BitStopperConfig, PagedDecodeOutput,
                                   paged_decode_rows, paged_decode_prep)
from repro_torch.kernels.runtime import load_library, on_card

LAUNCHES = 0
MAX_PAGE = 1024         # tokens a page may hold in the kernels (pages over
                        # 256 run the striped walk of csrc/paged_walk.cuh)

_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 12
             + [ctypes.c_void_p])


def _unpack_pages(kq_pages: torch.Tensor) -> torch.Tensor:
    """uint8 [B, bits, bs/8, Hkv, D] -> planes uint8 [B, bits, bs, Hkv, D]
    (token t of a page is bit ``t % 8`` of byte ``t // 8``)."""
    B, bits, bs8, Hkv, D = kq_pages.shape
    shifts = torch.arange(8, dtype=torch.int32, device=kq_pages.device)
    u = (kq_pages.to(torch.int32)[:, :, :, None]
         >> shifts.reshape(1, 1, 1, 8, 1, 1)) & 1
    return u.reshape(B, bits, bs8 * 8, Hkv, D).to(torch.uint8)


def _check(q, kq_pool, v_pool, table, lengths, q_positions, cfg):
    B, Hq, D = q.shape
    P, bits, bs8, Hkv, Dk = kq_pool.shape
    if bits != cfg.bits or Dk != D:
        raise ValueError(f"kq pool {tuple(kq_pool.shape)} does not match "
                         f"q {tuple(q.shape)} at bits={cfg.bits}")
    if v_pool.shape[:3] != (P, bs8 * 8, Hkv) or Hq % Hkv:
        raise ValueError(f"v pool {tuple(v_pool.shape)} does not match kq "
                         f"pool {tuple(kq_pool.shape)} / {Hq} query heads")
    if table.shape[0] != B or lengths.shape != (B,) or \
            q_positions.shape != (B,):
        raise ValueError("table/lengths/q_positions must have batch "
                         f"{B}, got {tuple(table.shape)}, "
                         f"{tuple(lengths.shape)}, {tuple(q_positions.shape)}")


def kernel_refusal(page: int, head_dim: int, v_width: int,
                   bits: int) -> str | None:
    """Why the CUDA kernels (decode and verify) refuse these widths, or
    None if they take them."""
    if page > MAX_PAGE or page % 8:
        return (f"pages of a multiple of 8 tokens, at most {MAX_PAGE}, got "
                f"{page}")
    if head_dim > 256 or head_dim % 16:
        return f"head_dim at most 256 and a multiple of 16, got {head_dim}"
    if v_width % 4:
        return f"a V width that is a multiple of 4, got {v_width}"
    if not 2 <= bits <= 16:
        return f"2..16 bits, got {bits}"
    return None


def check_kernel_operands(q, kq_pool, v_pool, table, lengths, q_positions,
                          cfg):
    """Shapes, plus what the CUDA kernels (decode and verify) take: the
    widths of :func:`kernel_refusal` and contiguous uint8 plane and f32 V
    pools, 16-byte aligned (they are copied in 16-byte pieces)."""
    _check(q, kq_pool, v_pool, table, lengths, q_positions, cfg)
    if kq_pool.dtype != torch.uint8 or v_pool.dtype != torch.float32:
        raise TypeError(f"kernel takes a uint8 plane pool and an f32 V pool, "
                        f"got {kq_pool.dtype} and {v_pool.dtype}")
    if not (kq_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("kq and V pools must be contiguous")
    _, bits, bs8, _, D = kq_pool.shape
    reason = kernel_refusal(bs8 * 8, D, v_pool.shape[-1], bits)
    if reason is not None:
        raise ValueError(f"the paged kernels take {reason}")
    if (kq_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("the paged kernels copy pool rows in 16-byte "
                         "pieces: the kq and V pools must be 16-byte aligned")


def paged_bitstopper_decode_plain(q, kq_pool, v_pool, table, lengths,
                                  q_positions, k_amax, v_amax,
                                  cfg: BitStopperConfig = BitStopperConfig(),
                                  window: int | None = None,
                                  stats: bool = True) -> PagedDecodeOutput:
    """The kernel's function in plain torch, over the packed plane pool."""
    _check(q, kq_pool, v_pool, table, lengths, q_positions, cfg)
    Hkv = kq_pool.shape[3]
    prep = paged_decode_prep(q, k_amax, v_amax, Hkv, cfg)
    q_int, m_min, m_max, scale_total, alpha_radius, _, v_scale = prep
    out, rounds, survivors, v_fetched = paged_decode_rows(
        q_int, m_min, m_max, scale_total, alpha_radius, table, lengths,
        q_positions, lambda phys: _unpack_pages(kq_pool[phys]), v_pool,
        v_scale, cfg, window)
    if not stats:
        return PagedDecodeOutput(out=out, rounds=rounds, survivors=None,
                                 v_fetched=None)
    return PagedDecodeOutput(out=out, rounds=rounds, survivors=survivors,
                             v_fetched=v_fetched)


def kernel_args(q, kq_pool, v_pool, table, lengths, q_positions, k_amax,
                v_amax, cfg: BitStopperConfig = BitStopperConfig(),
                window: int | None = None, stats: bool = True):
    """Prepare the kernel's operands and outputs once.  Returns ``(args,
    keep, out, rounds_h, surv)``: ``launch_c(*args)`` fills ``out
    [B,Hq,Dv]`` f32, ``rounds_h [B,Hkv,MB]`` int32 per-KV-head plane counts
    and ``surv`` int8 [B,Hq,MB*bs] (None when ``stats`` is False); ``keep``
    holds the prepared tensors that ``args`` points into, and must outlive
    every launch."""
    check_kernel_operands(q, kq_pool, v_pool, table, lengths, q_positions,
                          cfg)
    B, Hq, D = q.shape
    P, bits, bs8, Hkv, _ = kq_pool.shape
    bs = bs8 * 8
    MB = table.shape[1]
    Dv = v_pool.shape[-1]
    dev = q.device
    q_int, m_min, m_max, scale_total, alpha_radius, _, v_scale = \
        paged_decode_prep(q, k_amax, v_amax, Hkv, cfg)
    ints = [x.to(torch.int32).contiguous()
            for x in (table, lengths, q_positions)]
    floats = [x.contiguous() for x in (m_min, m_max, scale_total,
                                       alpha_radius, v_scale)]
    q_int = q_int.contiguous()
    out = torch.empty((B, Hq, Dv), dtype=torch.float32, device=dev)
    rounds_h = torch.empty((B, Hkv, MB), dtype=torch.int32, device=dev)
    surv = (torch.zeros((B, Hq, MB * bs), dtype=torch.int8, device=dev)
            if stats else None)
    args = (q_int.data_ptr(), *(f.data_ptr() for f in floats),
            kq_pool.data_ptr(), v_pool.data_ptr(),
            *(t.data_ptr() for t in ints), out.data_ptr(),
            rounds_h.data_ptr(), surv.data_ptr() if stats else None,
            B, Hq, Hkv, D, Dv, bits, bs, MB, cfg.min_rounds,
            int(cfg.quantize_v), int(window is not None), int(window or 0),
            torch.cuda.current_stream(dev).cuda_stream)
    return args, (q_int, floats, ints), out, rounds_h, surv


def launch_kernel(q, kq_pool, v_pool, table, lengths, q_positions, k_amax,
                  v_amax, cfg: BitStopperConfig = BitStopperConfig(),
                  window: int | None = None, stats: bool = True):
    """Launch the CUDA kernel once.  Returns ``(out [B,Hq,Dv] f32,
    rounds_h [B,Hkv,MB] int32, survivors int8 [B,Hq,MB*bs] or None)`` with
    per-KV-head plane counts."""
    args, _keep, out, rounds_h, surv = kernel_args(
        q, kq_pool, v_pool, table, lengths, q_positions, k_amax, v_amax,
        cfg=cfg, window=window, stats=stats)
    with torch.cuda.device(q.device):
        launch_c(*args)
    return out, rounds_h, surv


def entry_point(lib: ctypes.CDLL):
    """``paged_decode_launch`` of a library built from
    ``csrc/paged_decode.cu``, with its C signature."""
    fn = lib.paged_decode_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch_c(*args) -> None:
    """The C entry point ``paged_decode_launch`` (argument order of
    ``csrc/paged_decode.cu``); raises on a launch error and counts the
    launch."""
    global LAUNCHES
    err = entry_point(load_library("paged_decode"))(*args)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1


def copied_bytes() -> tuple[int, int]:
    """(plane bytes, V bytes) that the kernel requested from device memory,
    summed over its launches with ``stats`` on since the last call; the
    call zeroes both counts.  Synchronizes the card."""
    torch.cuda.synchronize()
    fn = load_library("paged_decode").paged_decode_copied_bytes
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 2)()
    err = fn(counts)
    if err != 0:
        raise RuntimeError(f"reading the paged_decode copy counts failed "
                           f"with CUDA error {err}")
    return int(counts[0]), int(counts[1])


def paged_bitstopper_decode(
    q: torch.Tensor,            # [B, Hq, D]: one decode query per slot
    kq_pool: torch.Tensor,      # [P, bits, bs//8, Hkv, D] uint8 plane pool
    v_pool: torch.Tensor,       # [P, bs, Hkv, Dv] V pool
    table: torch.Tensor,        # [B, MB] int32 block tables
    lengths: torch.Tensor,      # [B] int32 fill levels
    q_positions: torch.Tensor,  # [B] int32 absolute query positions
    k_amax: torch.Tensor,       # [Hkv] pool-wide running max|K|
    v_amax: torch.Tensor,       # [Hkv] pool-wide running max|V|
    cfg: BitStopperConfig = BitStopperConfig(),
    window: int | None = None,
    stats: bool = True,
) -> PagedDecodeOutput:
    """Fused paged BESF decode over every serving slot.

    CUDA tensors go through the hand-written kernel, CPU tensors through
    :func:`paged_bitstopper_decode_plain`.  ``stats=False`` (the serving
    path) returns ``survivors``/``v_fetched`` as None."""
    args = (q, kq_pool, v_pool, table, lengths, q_positions, k_amax, v_amax)
    if not on_card(*args):
        return paged_bitstopper_decode_plain(*args, cfg=cfg, window=window,
                                             stats=stats)
    out, rounds_h, surv = launch_kernel(*args, cfg=cfg, window=window,
                                        stats=stats)
    rounds = rounds_h.amax(1)
    if not stats:
        return PagedDecodeOutput(out=out, rounds=rounds, survivors=None,
                                 v_fetched=None)
    B, Hq, _ = q.shape
    MB = table.shape[1]
    survivors = surv.to(torch.bool)
    v_fetched = survivors.reshape(B, Hq, MB, -1).any(3).any(1)
    return PagedDecodeOutput(out=out, rounds=rounds, survivors=survivors,
                             v_fetched=v_fetched)

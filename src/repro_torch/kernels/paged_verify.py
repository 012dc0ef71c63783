"""Fused paged BESF verify: speculative decoding's draft-block scorer.

Counterpart of ``repro/kernels/paged_verify.py`` (the Pallas TPU kernel
``paged_bitstopper_verify``).  A slot brings an Sq-token draft block and
every query is scored exactly as the Sq=1 paged decode would score it at
its position.  Three pieces live here:

* :func:`paged_bitstopper_verify`, the wrapper with the reference's
  signature.  It prepares the operands in torch (``paged_decode_prep`` on
  the ``B*Sq`` flattened queries, as the reference does), then launches the
  CUDA kernel ``csrc/paged_verify.cu`` for CUDA tensors, or runs the plain
  version for CPU tensors.  A failed build or launch raises; there is no
  fallback.
* :func:`paged_bitstopper_verify_plain`, the same function in plain torch
  over the packed ``kq`` pool: the ``(slot, query)`` rows flattened to
  ``B*Sq`` decode rows, each slot's table broadcast to its queries, then
  the plain paged decode (page unpacking and the oracle's walk).
* ``LAUNCHES``, the number of kernel launches, and :func:`copied_bytes`,
  the plane and V bytes the kernel requested.

The kernel runs the decode kernel's page walk (``csrc/paged_walk.cuh``)
with one walk warp per (draft query, query head) row: one thread block
per (KV head, slot, group of queries), a group being at most
``max(1, 4 // G)`` whole queries.  A block copies the planes of every page
some row reaches once, and V of a page once when some row has a survivor.
It writes per-(KV head, query) plane counts; the reference's per-query
``rounds`` is their max over KV heads.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.besf import (BitStopperConfig, PagedVerifyOutput,
                                   paged_decode_prep)
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels.runtime import load_library, on_card

LAUNCHES = 0

_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 13
             + [ctypes.c_void_p])


def _check(q, table, lengths, q_positions):
    B, Sq = q.shape[:2]
    if q.ndim != 4 or table.shape[0] != B or \
            lengths.shape != (B, Sq) or q_positions.shape != (B, Sq):
        raise ValueError(f"verify takes q [B, Sq, Hq, D] with table [B, MB] "
                         f"and lengths/q_positions [B, Sq], got "
                         f"{tuple(q.shape)}, {tuple(table.shape)}, "
                         f"{tuple(lengths.shape)}, {tuple(q_positions.shape)}")


def _flat(q, table, lengths, q_positions):
    """(slot, query) rows -> ``B*Sq`` decode rows."""
    B, Sq, Hq, D = q.shape
    MB = table.shape[1]
    return (q.reshape(B * Sq, Hq, D),
            table[:, None].expand(B, Sq, MB).reshape(B * Sq, MB),
            lengths.reshape(B * Sq), q_positions.reshape(B * Sq))


def paged_bitstopper_verify_plain(q, kq_pool, v_pool, table, lengths,
                                  q_positions, k_amax, v_amax,
                                  cfg: BitStopperConfig = BitStopperConfig(),
                                  window: int | None = None,
                                  stats: bool = True) -> PagedVerifyOutput:
    """The kernel's function in plain torch, over the packed plane pool."""
    _check(q, table, lengths, q_positions)
    B, Sq, Hq, _ = q.shape
    MB = table.shape[1]
    fq, ft, fl, fp = _flat(q, table, lengths, q_positions)
    res = pd.paged_bitstopper_decode_plain(fq, kq_pool, v_pool, ft, fl, fp,
                                           k_amax, v_amax, cfg=cfg,
                                           window=window)
    out = res.out.reshape(B, Sq, Hq, -1)
    rounds = res.rounds.reshape(B, Sq, MB)
    if not stats:
        return PagedVerifyOutput(out=out, rounds=rounds, survivors=None,
                                 v_fetched=None)
    return PagedVerifyOutput(out=out, rounds=rounds,
                             survivors=res.survivors.reshape(B, Sq, Hq, -1),
                             v_fetched=res.v_fetched.reshape(B, Sq, MB))


def kernel_args(q, kq_pool, v_pool, table, lengths, q_positions, k_amax,
                v_amax, cfg: BitStopperConfig = BitStopperConfig(),
                window: int | None = None, stats: bool = True):
    """Prepare the kernel's operands and outputs once.  Returns ``(args,
    keep, out, rounds_h, surv)``: ``launch_c(*args)`` fills ``out
    [B,Sq,Hq,Dv]`` f32, ``rounds_h [B,Hkv,Sq,MB]`` int32 per-(KV head,
    query) plane counts and ``surv`` int8 [B,Sq*Hq,MB*bs] (None when
    ``stats`` is False); ``keep`` holds the prepared tensors that ``args``
    points into, and must outlive every launch.  Raises ``ValueError`` on
    widths the kernel does not take (those of the decode kernel)."""
    _check(q, table, lengths, q_positions)
    B, Sq, Hq, D = q.shape
    P, bits, bs8, Hkv, _ = kq_pool.shape
    bs = bs8 * 8
    MB = table.shape[1]
    Dv = v_pool.shape[-1]
    fq, ft, fl, fp = _flat(q, table, lengths, q_positions)
    pd.check_kernel_operands(fq, kq_pool, v_pool, ft, fl, fp, cfg)
    dev = q.device
    q_int, m_min, m_max, scale_total, alpha_radius, _, v_scale = \
        paged_decode_prep(fq, k_amax, v_amax, Hkv, cfg)
    ints = [x.to(torch.int32).contiguous()
            for x in (table, lengths, q_positions)]
    floats = [x.contiguous() for x in (m_min, m_max, scale_total,
                                       alpha_radius, v_scale)]
    q_int = q_int.contiguous()
    out = torch.empty((B, Sq, Hq, Dv), dtype=torch.float32, device=dev)
    rounds_h = torch.empty((B, Hkv, Sq, MB), dtype=torch.int32, device=dev)
    surv = (torch.zeros((B, Sq * Hq, MB * bs), dtype=torch.int8, device=dev)
            if stats else None)
    args = (q_int.data_ptr(), *(f.data_ptr() for f in floats),
            kq_pool.data_ptr(), v_pool.data_ptr(),
            *(t.data_ptr() for t in ints), out.data_ptr(),
            rounds_h.data_ptr(), surv.data_ptr() if stats else None,
            B, Sq, Hq, Hkv, D, Dv, bits, bs, MB, cfg.min_rounds,
            int(cfg.quantize_v), int(window is not None), int(window or 0),
            torch.cuda.current_stream(dev).cuda_stream)
    return args, (q_int, floats, ints), out, rounds_h, surv


def launch_kernel(q, kq_pool, v_pool, table, lengths, q_positions, k_amax,
                  v_amax, cfg: BitStopperConfig = BitStopperConfig(),
                  window: int | None = None, stats: bool = True):
    """Launch the CUDA kernel once.  Returns ``(out [B,Sq,Hq,Dv] f32,
    rounds_h [B,Hkv,Sq,MB] int32, survivors int8 [B,Sq*Hq,MB*bs] or
    None)`` with per-(KV head, query) plane counts."""
    args, _keep, out, rounds_h, surv = kernel_args(
        q, kq_pool, v_pool, table, lengths, q_positions, k_amax, v_amax,
        cfg=cfg, window=window, stats=stats)
    with torch.cuda.device(q.device):
        launch_c(*args, v_dtype=v_pool.dtype)
    return out, rounds_h, surv


def entry_point(lib: ctypes.CDLL):
    """``paged_verify_launch`` of a library built from
    ``csrc/paged_verify.cu``, with its C signature."""
    fn = lib.paged_verify_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch_c(*args, v_dtype: torch.dtype = torch.float32) -> None:
    """The C entry point ``paged_verify_launch`` of the library for a V
    pool of ``v_dtype`` (``paged_verify`` or ``paged_verify_bf16``;
    argument order of ``csrc/paged_verify.cu``); raises on a launch error
    and counts the launch."""
    global LAUNCHES
    lib = "paged_verify" + pd.V_DTYPES[v_dtype][0]
    err = entry_point(load_library(lib))(*args)
    if err != 0:
        raise RuntimeError(f"paged_verify kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1


def copied_bytes() -> tuple[int, int]:
    """(plane bytes, V bytes) that the kernel requested from device memory,
    summed over its launches with ``stats`` on since the last call, over
    both V pool types; the call zeroes the counts.  Synchronizes the
    card."""
    return pd.copied_bytes("paged_verify")


def paged_bitstopper_verify(
    q: torch.Tensor,            # [B, Sq, Hq, D]: draft block per slot
    kq_pool: torch.Tensor,      # [P, bits, bs//8, Hkv, D] uint8 plane pool
    v_pool: torch.Tensor,       # [P, bs, Hkv, Dv] V pool
    table: torch.Tensor,        # [B, MB] int32 block tables
    lengths: torch.Tensor,      # [B, Sq] int32 per-query fill levels
    q_positions: torch.Tensor,  # [B, Sq] int32 per-query absolute positions
    k_amax: torch.Tensor,       # [Hkv] pool-wide running max|K|
    v_amax: torch.Tensor,       # [Hkv] pool-wide running max|V|
    cfg: BitStopperConfig = BitStopperConfig(),
    window: int | None = None,
    stats: bool = True,
) -> PagedVerifyOutput:
    """Fused paged BESF verify over every serving slot's draft block.

    CUDA tensors go through the hand-written kernel, CPU tensors through
    :func:`paged_bitstopper_verify_plain`.  ``stats=False`` (the serving
    path) returns ``survivors``/``v_fetched`` as None."""
    args = (q, kq_pool, v_pool, table, lengths, q_positions, k_amax, v_amax)
    if not on_card(*args):
        return paged_bitstopper_verify_plain(*args, cfg=cfg, window=window,
                                             stats=stats)
    out, rounds_h, surv = launch_kernel(*args, cfg=cfg, window=window,
                                        stats=stats)
    rounds = rounds_h.amax(1)
    if not stats:
        return PagedVerifyOutput(out=out, rounds=rounds, survivors=None,
                                 v_fetched=None)
    B, Sq, Hq, _ = q.shape
    MB = table.shape[1]
    survivors = surv.reshape(B, Sq, Hq, -1).to(torch.bool)
    v_fetched = survivors.reshape(B, Sq, Hq, MB, -1).any(4).any(2)
    return PagedVerifyOutput(out=out, rounds=rounds, survivors=survivors,
                             v_fetched=v_fetched)

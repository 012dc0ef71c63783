"""Fused BitStopper attention over contiguous K: the uncached forward's
``attn_impl="bitstopper"`` path.

Counterpart of ``repro/kernels/bitstopper_qk.py`` (the Pallas TPU kernel
``bitstopper_attention_kernel``).  Three pieces live here:

* :func:`bitstopper_attention_kernel`, the wrapper with the reference's
  signature.  It prepares the operands in torch as the reference does
  outside ``pallas_call`` (:func:`prep`: per-slice INT quantization of q
  and k, packed K bit planes, bit margins, the two LATS scalars, V
  dequantized), then launches ``csrc/bitstopper_qk.cu`` once over all
  (batch x head) slices for CUDA tensors, or runs the plain version for CPU
  tensors.  Head and value widths over 160 (up to 256) run the source's
  wide instantiations, which stage V in column chunks.  A failed build or
  launch raises; there is no fallback.
* :func:`bitstopper_qk_plain`, the same function in plain torch on the same
  operands: the planes unpacked, then the block oracle
  (``core/block_adaptation.block_rows``).
* ``LAUNCHES``, the number of kernel launches.

The kernel copies packed planes ``LOOKAHEAD`` planes ahead of the one in
use; :func:`design_plane_bytes` is what that design requests for a launch's
``rounds``, and :func:`count_copies` / :func:`copied_bytes` read what the
kernel itself counted.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import quantization as qlib
from repro_torch.core.besf import BitStopperConfig
from repro_torch.core.block_adaptation import block_prep, block_rows
from repro_torch.kernels.runtime import (load_library, on_card,
                                         width_refusal)

LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
MAX_BLOCK = 128             # largest q or kv tile the kernel takes
LOOKAHEAD = 2               # planes requested ahead (kLook in the source)


class KernelOutput(NamedTuple):
    out: torch.Tensor        # [..., Sq, dv] f32 attention output
    rounds: torch.Tensor     # [..., n_qt, n_kb] int32 planes fetched per block
    survivors: torch.Tensor  # [..., Sq, Sk] int8 token-level keep mask


class Operands(NamedTuple):
    """What the kernel reads, per slice (leading dim N)."""
    q_int: torch.Tensor      # [N, Sq, d] int32
    k_packed: torch.Tensor   # [N, bits, Sk/8, d] uint8, 8 tokens a byte
    v_eff: torch.Tensor      # [N, Sk, dv] f32
    m_min: torch.Tensor      # [N, bits, Sq] f32
    m_max: torch.Tensor      # [N, bits, Sq] f32
    scalars: torch.Tensor    # [N, 2] f32: scale_total, alpha * radius_int


def prep(q, k, v, cfg: BitStopperConfig) -> Operands:
    """q [N, Sq, d], k [N, Sk, d], v [N, Sk, dv] -> the kernel's operands,
    with the reference's float operations in its order
    (``bitstopper_qk.py:319-338``; quantization is per slice)."""
    ops = block_prep(q, k, v, cfg)
    planes = qlib.to_bitplanes(ops.k_int, cfg.bits)          # [bits, N, Sk, d]
    k_packed = qlib.pack_planes_seq(planes).transpose(0, 1).contiguous()
    return Operands(
        q_int=ops.q_int.contiguous(), k_packed=k_packed,
        v_eff=ops.v_eff.contiguous(),
        m_min=ops.m_min.transpose(0, 1).contiguous(),
        m_max=ops.m_max.transpose(0, 1).contiguous(),
        scalars=torch.stack([ops.scale_total, ops.alpha_radius], 1)
        .contiguous())


def _blocks(Sq: int, Sk: int, block_q: int, block_k: int) -> tuple[int, int]:
    """The reference's clamps and its tiling check (an assertion there)."""
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq or Sk % bk or bk % 8:
        raise ValueError(f"sequence lengths ({Sq}, {Sk}) are not tiled by "
                         f"blocks ({bq}, {bk}) with the kv block a multiple "
                         f"of 8")
    return bq, bk


def _causal_mask(Sq: int, Sk: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((Sq, Sk), dtype=torch.bool, device=device),
                      diagonal=Sk - Sq)


def bitstopper_qk_plain(ops: Operands, cfg: BitStopperConfig, bq: int,
                        bk: int, causal: bool) -> KernelOutput:
    """The kernel's function in plain torch on its operands."""
    N, Sq, _ = ops.q_int.shape
    Sk = ops.v_eff.shape[1]
    planes = qlib.unpack_planes_seq(ops.k_packed).transpose(0, 1)
    mask = _causal_mask(Sq, Sk, ops.q_int.device) if causal else None
    res = block_rows(ops.q_int, planes, ops.v_eff,
                     ops.m_min.transpose(0, 1), ops.m_max.transpose(0, 1),
                     ops.scalars[:, 0], ops.scalars[:, 1], mask, cfg, bq, bk)
    return KernelOutput(out=res.out, rounds=res.stats.rounds_per_block,
                        survivors=res.stats.survivors.to(torch.int8))


def kernel_args(ops: Operands, cfg: BitStopperConfig, bq: int, bk: int,
                causal: bool):
    """The C entry point's arguments for one launch over every slice of
    ``ops`` on the card, and its freshly allocated outputs.  Returns
    ``(args, KernelOutput)``."""
    N, Sq, D = ops.q_int.shape
    Sk, Dv = ops.v_eff.shape[1], ops.v_eff.shape[2]
    reason = width_refusal(D, Dv)
    if reason is not None or bq > MAX_BLOCK or bk > MAX_BLOCK:
        raise ValueError(f"the bitstopper_qk kernel takes "
                         f"{reason or 'these widths'} and blocks up to "
                         f"{MAX_BLOCK}, got blocks ({bq}, {bk})")
    dev = ops.q_int.device
    out = torch.empty((N, Sq, Dv), dtype=torch.float32, device=dev)
    rounds = torch.empty((N, Sq // bq, Sk // bk), dtype=torch.int32,
                         device=dev)
    surv = torch.empty((N, Sq, Sk), dtype=torch.int8, device=dev)
    args = (ops.q_int.data_ptr(), ops.k_packed.data_ptr(),
            ops.v_eff.data_ptr(), ops.m_min.data_ptr(), ops.m_max.data_ptr(),
            ops.scalars.data_ptr(), out.data_ptr(), rounds.data_ptr(),
            surv.data_ptr(), N, Sq, Sk, D, Dv, cfg.bits, bq, bk,
            cfg.min_rounds, int(causal),
            torch.cuda.current_stream(dev).cuda_stream)
    return args, KernelOutput(out=out, rounds=rounds, survivors=surv)


def launch_kernel(ops: Operands, cfg: BitStopperConfig, bq: int, bk: int,
                  causal: bool) -> KernelOutput:
    """One launch over every slice of ``ops`` on the card."""
    args, res = kernel_args(ops, cfg, bq, bk, causal)
    with torch.cuda.device(ops.q_int.device):
        launch_c(*args)
    return res


def entry_point(lib: ctypes.CDLL):
    """``bitstopper_qk_launch`` of a library built from
    ``csrc/bitstopper_qk.cu``, with its C signature."""
    fn = lib.bitstopper_qk_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch_c(*args) -> None:
    """The C entry point ``bitstopper_qk_launch`` (argument order of
    ``csrc/bitstopper_qk.cu``); raises on a launch error and counts the
    launch."""
    global LAUNCHES
    err = entry_point(load_library("bitstopper_qk"))(*args)
    if err != 0:
        raise RuntimeError(f"bitstopper_qk kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1


def count_copies(on: bool) -> None:
    """Whether later launches add the plane and V bytes they request to
    the kernel's device counters (off by default, as the forward runs)."""
    lib = load_library("bitstopper_qk")
    lib.bitstopper_qk_count_copies.argtypes = [ctypes.c_int]
    lib.bitstopper_qk_count_copies(int(on))


def copied_bytes() -> tuple[int, int]:
    """(plane bytes, V bytes) that the kernel requested from device memory,
    summed over its launches with counting on since the last call; the
    call zeroes both counts.  Synchronizes the card."""
    torch.cuda.synchronize()
    fn = load_library("bitstopper_qk").bitstopper_qk_copied_bytes
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 2)()
    err = fn(ctypes.addressof(counts))
    if err != 0:
        raise RuntimeError(f"reading the bitstopper_qk copy counters failed "
                           f"with CUDA error {err}")
    return int(counts[0]), int(counts[1])


def design_plane_bytes(rounds: torch.Tensor, bits: int, bk: int,
                       d: int) -> int:
    """Plane bytes the kernel's design requests for a launch whose plane
    counts are ``rounds`` [..., n_qt, n_kb]: a reachable tile (rounds > 0)
    requests its planes up to ``LOOKAHEAD`` past the last one it used, at
    most ``bits``; an unreachable one requests none.  A plane of a tile is
    bk / 8 x d bytes."""
    planes = torch.where(rounds > 0,
                         torch.clamp(rounds.long() + LOOKAHEAD, max=bits), 0)
    return int(planes.sum()) * (bk // 8) * d


def bitstopper_attention_kernel(
    q: torch.Tensor,            # [..., Sq, d] float
    k: torch.Tensor,            # [..., Sk, d] float
    v: torch.Tensor,            # [..., Sk, dv] float
    cfg: BitStopperConfig = BitStopperConfig(),
    block_q: int = 128,
    block_k: int = 128,
    causal: bool = False,
) -> KernelOutput:
    """Quantize, pack and run fused BitStopper attention.  Every leading
    index is one slice with its own quantization scales; the outputs keep
    the leading dims."""
    Sq, Sk = q.shape[-2], k.shape[-2]
    bq, bk = _blocks(Sq, Sk, block_q, block_k)
    card = on_card(q, k, v)
    flat = lambda x: x.reshape((-1,) + x.shape[-2:])
    ops = prep(flat(q), flat(k), flat(v), cfg)
    if card:
        res = launch_kernel(ops, cfg, bq, bk, causal)
    else:
        res = bitstopper_qk_plain(ops, cfg, bq, bk, causal)
    lead = q.shape[:-2]
    return KernelOutput(*(x.reshape(lead + x.shape[1:]) for x in res))

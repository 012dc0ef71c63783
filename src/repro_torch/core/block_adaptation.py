"""Block-granular BESF: the prefill score path of the paged engine.

Counterpart of ``repro/core/block_adaptation.py``.  A kv block stops
fetching bit planes once no (query, key) pair of the q tile x kv block can
still beat its query's LATS threshold; individually pruned tokens are
masked out of the softmax.  Thresholds use the running prefix max of the
lower bounds over the kv blocks seen so far.

The reference ``vmap``s this over q tiles and (batch, head) slices; here
both are batch dimensions written out (``N`` slices x ``n_qt`` tiles), and
the kv-block and bit-round scans are Python loops.  Plain torch, because
the reference has no Pallas kernel on this path either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import margins as margins_lib
from repro_torch.core import quantization as qlib
from repro_torch.core.besf import BitStopperConfig
from repro_torch.core.lats import NEG_INF


class BlockStats(NamedTuple):
    rounds_per_block: torch.Tensor   # [..., n_qt, n_kb] int32
    block_alive: torch.Tensor        # [..., n_qt, n_kb] bool
    survivors: torch.Tensor          # [..., Sq, Sk] bool


class BlockBESFOutput(NamedTuple):
    out: torch.Tensor                # [..., Sq, dv]
    scores: torch.Tensor             # [..., Sq, Sk] final logits
    stats: BlockStats


def _quantize_rows(x: torch.Tensor, bits: int):
    """Per-slice :func:`qlib.quantize` over a leading batch of [S, d]
    slices, in ``x``'s dtype -> (int32 values, f32 scale [N])."""
    q, scale = qlib.quantize(x, bits, dims=(1, 2))
    return q, scale.reshape(-1)


class BlockOperands(NamedTuple):
    """What block BESF reads after quantization, per (batch, head) slice."""
    q_int: torch.Tensor              # [N, Sq, d] int32
    k_int: torch.Tensor              # [N, Sk, d] int32
    v_eff: torch.Tensor              # [N, Sk, dv] f32
    m_min: torch.Tensor              # [bits, N, Sq] f32
    m_max: torch.Tensor              # [bits, N, Sq] f32
    scale_total: torch.Tensor        # [N] f32: q_scale * k_scale * sm_scale
    alpha_radius: torch.Tensor       # [N] f32: alpha * radius / scale_total


def block_prep(q, k, v, cfg: BitStopperConfig) -> BlockOperands:
    """Per-slice quantization, margins and LATS scalars of q [N, Sq, d],
    k [N, Sk, d], v [N, Sk, dv], with the reference's float operations in
    its order (``bitstopper_qk.py:319-338``, ``block_adaptation.py:53-69``).
    K and V quantize in their own dtype, as the reference's do: a bf16
    cache's view gets bf16 scales and quotients."""
    bits = cfg.bits
    sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    q_int, q_scale = _quantize_rows(q.float(), bits)
    k_int, k_scale = _quantize_rows(k, bits)
    m_min, m_max = margins_lib.bit_margins(q_int, bits)
    scale_total = q_scale * k_scale * sm_scale
    # A true IEEE division (``python_float / tensor`` is not one in torch).
    radius_int = torch.full_like(scale_total, cfg.radius) / scale_total
    if cfg.quantize_v:
        v_int, v_scale = _quantize_rows(v, bits)
        v_eff = v_int.float() * v_scale[:, None, None]
    else:
        v_eff = v.float()
    return BlockOperands(q_int, k_int, v_eff, m_min, m_max, scale_total,
                         cfg.alpha * radius_int)


def _block_single(q, k, v, mask, cfg: BitStopperConfig, block_q: int,
                  block_k: int) -> BlockBESFOutput:
    """q [N, Sq, d], k [N, Sk, d], v [N, Sk, dv], mask [Sq, Sk] bool shared
    by every slice (or None)."""
    ops = block_prep(q, k, v, cfg)
    planes = qlib.to_bitplanes(ops.k_int, cfg.bits)          # [bits, N, Sk, d]
    return block_rows(ops.q_int, planes, ops.v_eff, ops.m_min, ops.m_max,
                      ops.scale_total, ops.alpha_radius, mask, cfg, block_q,
                      block_k)


def block_rows(q_int, planes, v_eff, m_min, m_max, scale_total,
               alpha_radius, mask, cfg: BitStopperConfig, block_q: int,
               block_k: int) -> BlockBESFOutput:
    """Block BESF over prepared operands: q_int [N, Sq, d], planes uint8
    [bits, N, Sk, d], v_eff [N, Sk, dv], m_min/m_max [bits, N, Sq],
    scale_total/alpha_radius [N], mask [Sq, Sk] bool (or None)."""
    N, Sq, d = q_int.shape
    Sk, dv = v_eff.shape[1], v_eff.shape[2]
    bits = cfg.bits
    if Sq % block_q or Sk % block_k:
        raise ValueError(f"({Sq}, {Sk}) not tiled by ({block_q}, {block_k})")
    n_qt, n_kb = Sq // block_q, Sk // block_k
    dev = q_int.device
    w = qlib.plane_weights_int(bits, dev).double()
    ar = alpha_radius[:, None, None]
    valid = (torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
             if mask is None else mask.to(torch.bool))

    valid_b = valid.reshape(n_qt, block_q, n_kb, block_k)
    q_tiles = q_int.reshape(N, n_qt, block_q, d).double()
    mmin_t = m_min.reshape(bits, N, n_qt, block_q)
    mmax_t = m_max.reshape(bits, N, n_qt, block_q)
    planes_b = planes.reshape(bits, N, n_kb, block_k, d)
    st = scale_total[:, None, None, None]
    neg = torch.full((N, n_qt, block_q, block_k), NEG_INF,
                     dtype=torch.float32, device=dev)

    m_low = torch.full((N, n_qt, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
    m_run = m_low.clone()
    l_run = torch.zeros_like(m_low)
    acc = torch.zeros((N, n_qt, block_q, dv), dtype=torch.float32, device=dev)
    rounds_all, alive_all, surv_all, logit_all = [], [], [], []
    for kb in range(n_kb):
        vmask = valid_b[:, :, kb, :]                          # [n_qt, Bq, Bk]
        # Ungated prefix sums of every round's plane contribution (exact in
        # float64); a block's gated partial equals them while it is live,
        # and a dead block's tokens are masked out of every later use.
        dots = torch.einsum("ntqd,rnkd->rntqk", q_tiles,
                            planes_b[:, :, kb].double())
        partials = torch.cumsum(w[:, None, None, None, None] * dots,
                                dim=0).to(torch.int32)
        tok_alive = vmask[None].expand(N, n_qt, block_q, block_k)
        blk_alive = vmask.any(2).any(1)[None].expand(N, n_qt)
        rounds = torch.zeros((N, n_qt), dtype=torch.int32, device=dev)
        for r in range(bits):
            rounds = rounds + blk_alive.to(torch.int32)
            part = partials[r].float()
            lower = part + mmin_t[r][..., None]
            upper = part + mmax_t[r][..., None]
            low_here = torch.where(vmask & tok_alive, lower, neg).amax(-1)
            m_low_new = torch.where(blk_alive[..., None],
                                    torch.maximum(m_low, low_here), m_low)
            eta = m_low_new - ar
            if r < cfg.min_rounds - 1:
                keep = tok_alive & vmask
            else:
                keep = tok_alive & (upper >= eta[..., None]) & vmask
            keep = torch.where(blk_alive[..., None, None], keep, tok_alive)
            blk_alive = torch.where(blk_alive, keep.any(3).any(2), blk_alive)
            tok_alive = keep
            m_low = m_low_new

        survived = tok_alive & (rounds == bits)[..., None, None]
        logits = torch.where(survived, partials[bits - 1].float() * st, neg)
        m_new = torch.maximum(m_run, logits.amax(-1))
        # The weights come from a float64 exp rounded to f32, and the sums
        # run in float64, rounded to f32 once per state update: the CUDA
        # kernel sums in another order, and this keeps the two equal but
        # in rare roundings (the reference sums in f32; within 2e-5).
        p = torch.exp((logits - m_new[..., None]).double()).float()
        p = torch.where(survived, p, torch.zeros_like(p)).double()
        corr = torch.where(m_run == NEG_INF,
                           torch.zeros_like(m_run, dtype=torch.float64),
                           torch.exp((m_run - m_new).double()))
        l_run = (l_run.double() * corr + p.sum(-1)).float()
        v_blk = v_eff[:, kb * block_k:(kb + 1) * block_k]     # [N, Bk, dv]
        acc = (acc.double() * corr[..., None]
               + torch.einsum("ntqk,nkd->ntqd", p, v_blk.double())).float()
        m_run = m_new
        rounds_all.append(rounds)
        alive_all.append(survived.any(3).any(2))
        surv_all.append(survived)
        logit_all.append(logits)

    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    survivors = torch.stack(surv_all, 3).reshape(N, Sq, Sk)
    scores = torch.stack(logit_all, 3).reshape(N, Sq, Sk)
    return BlockBESFOutput(
        out=out.reshape(N, Sq, dv),
        scores=scores,
        stats=BlockStats(rounds_per_block=torch.stack(rounds_all, 2),
                         block_alive=torch.stack(alive_all, 2),
                         survivors=survivors))


def block_bitstopper_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: BitStopperConfig = BitStopperConfig(),
    block_q: int = 64,
    block_k: int = 64,
    causal: bool = False,
    mask: torch.Tensor | None = None,
) -> BlockBESFOutput:
    """Block-granular streaming BitStopper.

    q [..., Sq, d], k [..., Sk, d], v [..., Sk, dv]; ``mask`` [Sq, Sk] is
    shared by every leading index, as in the reference."""
    Sq, Sk = q.shape[-2], k.shape[-2]
    if causal:
        cmask = torch.tril(torch.ones((Sq, Sk), dtype=torch.bool,
                                      device=q.device), diagonal=Sk - Sq)
        mask = cmask if mask is None else (mask & cmask)
    lead = q.shape[:-2]
    res = _block_single(q.reshape((-1,) + q.shape[-2:]),
                        k.reshape((-1,) + k.shape[-2:]),
                        v.reshape((-1,) + v.shape[-2:]),
                        mask, cfg, block_q, block_k)

    def unflat(x):
        return x.reshape(lead + x.shape[1:])

    return BlockBESFOutput(
        out=unflat(res.out), scores=unflat(res.scores),
        stats=BlockStats(*(unflat(x) for x in res.stats)))

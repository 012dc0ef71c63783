"""Bit-serial Enabled Stage Fusion (BESF): the per-token reference and the
paged decode and verify oracles.

Counterpart of ``repro/core/besf.py``.  Keys are INT12-quantized (per
slice, or under the pool-wide running scales on the paged paths) and
consumed one bit plane at a time (MSB first); after each round LATS
prunes the candidates whose score interval can no longer reach the
threshold, and survivors of every round carry their exact integer score
into the softmax.

:func:`besf_attention_decode_paged` is the pure-torch oracle and the
``fused_decode=False`` path of the engine; the CUDA kernel in
``repro_torch/kernels/paged_decode.py`` must match its integer observables
(``rounds``, survivors, ``v_fetched``) exactly.
:func:`besf_attention_verify_paged` is the same for a speculative draft
block, held against ``repro_torch/kernels/paged_verify.py``.
:func:`besf_attention` is the paper-faithful per-token BESF with the global
max LATS threshold: the algorithmic ground truth whose survivors the block
variants' must contain.  :func:`besf_attention_decode` is its single-query
form, the decode of a paged pool with no plane pool (a page size that is
not a multiple of 8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import margins as margins_lib
from repro_torch.core import quantization as qlib
from repro_torch.core.lats import NEG_INF, lats_keep, lats_threshold


@dataclasses.dataclass(frozen=True)
class BitStopperConfig:
    """Algorithm hyper-parameters (paper defaults)."""

    bits: int = 12
    alpha: float = 0.6
    radius: float = 5.0
    quantize_v: bool = True     # paper: S x V at 12-bit
    min_rounds: int = 1         # never prune before this many planes are seen

    def replace(self, **kw) -> "BitStopperConfig":
        return dataclasses.replace(self, **kw)


class BESFStats(NamedTuple):
    planes_fetched: torch.Tensor  # [..., Sq, Sk] int32 planes per pair
    survivors: torch.Tensor       # [..., Sq, Sk] bool alive after all rounds
    valid: torch.Tensor           # [..., Sq, Sk] bool attention-mask validity


class BESFOutput(NamedTuple):
    out: torch.Tensor             # [..., Sq, dv]
    probs: torch.Tensor           # [..., Sq, Sk] softmax over survivors
    scores: torch.Tensor          # [..., Sq, Sk] logits (NEG_INF if pruned)
    stats: BESFStats


def _besf_rows(q, k, v, valid, cfg: BitStopperConfig) -> BESFOutput:
    """Counterpart of the reference's ``_besf_single`` with the slices
    written out: q [N, Sq, d], k [N, Sk, d], v [N, Sk, dv] float, valid
    [N, Sq, Sk] bool.  Quantization is per slice."""
    from repro_torch.core.block_adaptation import block_prep
    bits = cfg.bits
    ops = block_prep(q, k, v, cfg)
    planes = qlib.to_bitplanes(ops.k_int, bits)              # [bits, N, Sk, d]
    w = qlib.plane_weights_int(bits, q.device)
    # Plane dots in float64, exact for these small integers on any device.
    dots = torch.einsum("nqd,rnkd->rnqk", ops.q_int.double(),
                        planes.double()).to(torch.int32)
    radius_int = torch.full_like(ops.scale_total, cfg.radius) / ops.scale_total
    partial = torch.zeros(dots.shape[1:], dtype=torch.int32, device=q.device)
    alive = valid
    fetched = torch.zeros_like(partial)
    for r in range(bits):
        fetched = fetched + alive.to(torch.int32)
        partial = partial + torch.where(alive, w[r] * dots[r],
                                        torch.zeros_like(partial))
        lower = partial.float() + ops.m_min[r][..., None]
        upper = partial.float() + ops.m_max[r][..., None]
        eta = lats_threshold(lower, alive, cfg.alpha, radius_int[:, None])
        keep = lats_keep(upper, eta, alive)
        alive = alive if r < cfg.min_rounds - 1 else keep
    neg = torch.full_like(lower, NEG_INF)
    logits = torch.where(alive, partial.float()
                         * ops.scale_total[:, None, None], neg)
    logits = torch.where(valid, logits, neg)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(alive & valid, probs, torch.zeros_like(probs))
    out = probs @ ops.v_eff
    return BESFOutput(out=out, probs=probs, scores=logits,
                      stats=BESFStats(planes_fetched=fetched,
                                      survivors=alive, valid=valid))


def besf_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: BitStopperConfig = BitStopperConfig(),
                   mask: torch.Tensor | None = None,
                   causal: bool = False) -> BESFOutput:
    """BitStopper attention, the faithful per-token reference: q [..., Sq,
    d], k/v [..., Sk, *]; ``mask`` [Sq, Sk] or broadcastable to [..., Sq,
    Sk]."""
    Sq, Sk = q.shape[-2], k.shape[-2]
    lead = q.shape[:-2]
    if causal:
        cmask = torch.tril(torch.ones((Sq, Sk), dtype=torch.bool,
                                      device=q.device), diagonal=Sk - Sq)
        mask = cmask if mask is None else (mask & cmask)
    if mask is None:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    valid = torch.broadcast_to(mask.to(torch.bool), lead + (Sq, Sk))
    res = _besf_rows(q.reshape((-1,) + q.shape[-2:]),
                     k.reshape((-1,) + k.shape[-2:]),
                     v.reshape((-1,) + v.shape[-2:]),
                     valid.reshape(-1, Sq, Sk), cfg)

    def unflat(x):
        return x.reshape(lead + x.shape[1:])

    return BESFOutput(out=unflat(res.out), probs=unflat(res.probs),
                      scores=unflat(res.scores),
                      stats=BESFStats(*(unflat(x) for x in res.stats)))


def besf_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cfg: BitStopperConfig = BitStopperConfig(),
                          mask: torch.Tensor | None = None) -> BESFOutput:
    """Single-query BitStopper attention (the decode of a planeless paged
    pool): q [..., 1, d], k [..., Sk, d], v [..., Sk, dv]; ``mask``
    broadcastable to ``q.shape[:-2] + (1, Sk)``, so each serving slot has
    its own.

    The reference's ``_besf_decode_single`` takes every plane's dot in one
    contraction and prefix-sums them instead of gating the partials round
    by round; a candidate alive at round r has accumulated exactly planes
    0..r either way, and pruned candidates reach neither the threshold nor
    the output, so the per-token rows here give its survivors,
    ``planes_fetched`` and scores."""
    if q.shape[-2] != 1:
        raise ValueError(f"decode path is single-query (got Sq="
                         f"{q.shape[-2]}); use besf_attention")
    return besf_attention(q, k, v, cfg=cfg, mask=mask)


class PagedDecodeOutput(NamedTuple):
    out: torch.Tensor        # [B, Hq, dv] attention output
    rounds: torch.Tensor     # [B, n_blocks] int32: bit planes fetched per page
    survivors: torch.Tensor | None  # [B, Hq, n_blocks*page_size] bool
    v_fetched: torch.Tensor | None  # [B, n_blocks] bool: V page actually read


def paged_decode_prep(q: torch.Tensor, k_amax: torch.Tensor,
                      v_amax: torch.Tensor, n_kv_heads: int,
                      cfg: BitStopperConfig):
    """Operands shared by the oracle and the kernel, which must see them
    bit-identical.

    ``q`` [B, Hq, d] (one decode query per slot); ``k_amax``/``v_amax``
    [Hkv] are the pool-wide running max-abs per KV head.  Returns
    ``(q_int, m_min, m_max, scale_total, alpha_radius, k_scale, v_scale)``:
    per-(slot, head) query quantization, K/V scales shared by every slot."""
    B, Hq, d = q.shape
    bits = cfg.bits
    sm_scale = 1.0 / (d ** 0.5)
    G = Hq // n_kv_heads
    flat = q.reshape(B * Hq, d).float()
    q_scale = qlib.scale_from_amax(flat.abs().amax(1), bits)
    q_int = qlib.quantize_with_scale(flat, q_scale[:, None], bits)
    q_int = q_int.reshape(B, Hq, d)
    m_min, m_max = margins_lib.bit_margins(q_int, bits)      # [bits, B, Hq]
    k_scale = qlib.scale_from_amax(k_amax, bits)              # [Hkv]
    v_scale = qlib.scale_from_amax(v_amax, bits)
    k_scale_h = k_scale.repeat_interleave(G)                  # [Hq]
    scale_total = q_scale.reshape(B, Hq) * k_scale_h[None] * sm_scale
    # A true IEEE division: ``python_float / tensor`` would go through a
    # reciprocal and a multiply and differ from the reference in the last
    # bit.
    radius_int = torch.full_like(scale_total, cfg.radius) / scale_total
    alpha_radius = cfg.alpha * radius_int
    return q_int, m_min, m_max, scale_total, alpha_radius, k_scale, v_scale


def _plane_dots(q_int: torch.Tensor, planes: torch.Tensor,
                bits: int) -> torch.Tensor:
    """Ungated partial scores of every round.

    ``q_int`` [B, Hkv, G, d], ``planes`` uint8 [B, bits, bs, Hkv, d] ->
    int32 [B, bits, Hkv*G, bs], entry r = sum over planes 0..r of
    ``w_r * (q . plane_r)``.  The dot runs in float64, exact for these
    small integers on any device (CUDA has no int32 matmul).  A candidate
    alive at round r has accumulated exactly planes 0..r, so the ungated
    prefix sum equals its gated partial; pruned candidates are masked out
    of every later use."""
    B, Hkv, G, d = q_int.shape
    w = qlib.plane_weights_int(bits, q_int.device).double()
    dots = torch.einsum("bkgd,brtkd->brkgt", q_int.double(), planes.double())
    partials = torch.cumsum(w[None, :, None, None, None] * dots, dim=1)
    return partials.to(torch.int32).reshape(B, bits, Hkv * G, -1)


def paged_decode_rows(
    q_int, m_min, m_max,        # [B, Hq, d] int32; [bits, B, Hq] f32
    scale_total, alpha_radius,  # [B, Hq] f32
    table, lengths, q_pos,      # [B, MB], [B], [B] int
    page_planes: Callable,      # phys [B] -> uint8 [B, bits, bs, Hkv, d]
    v_pool,                     # [P, bs, Hkv, dv]
    v_scale,                    # [Hkv] f32
    cfg: BitStopperConfig,
    window: int | None,
):
    """Every slot's paged BESF decode, pages walked in logical order.

    Counterpart of ``_paged_decode_row`` with the slot dimension written
    out.  LATS uses the prefix-max lower bound over the pages seen so far;
    a page whose every (head, token) candidate is pruned stops consuming
    planes, and its V counts as fetched only if a token survives every
    round.  A page with no valid token changes nothing: its ``blk_live``
    starts False, which gates every state update below exactly as the
    reference's dead-page branch does."""
    B, Hq, d = q_int.shape
    P, bs, Hkv, dv = v_pool.shape
    MB = table.shape[1]
    bits = cfg.bits
    G = Hq // Hkv
    dev = q_int.device
    qg = q_int.reshape(B, Hkv, G, d)
    neg = torch.full((B, Hq, bs), NEG_INF, dtype=torch.float32, device=dev)

    mlow = torch.full((B, Hq), NEG_INF, dtype=torch.float32, device=dev)
    m_run = torch.full((B, Hq), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((B, Hq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hq, dv), dtype=torch.float32, device=dev)
    rounds_all, surv_all, vf_all = [], [], []
    lengths = lengths.to(torch.int64)
    q_pos = q_pos.to(torch.int64)
    for j in range(MB):
        t_pos = j * bs + torch.arange(bs, device=dev)
        valid = ((t_pos[None] <= q_pos[:, None])
                 & (t_pos[None] < lengths[:, None]))
        if window is not None:
            valid &= t_pos[None] > q_pos[:, None] - window
        phys = table[:, j].long()
        partials = _plane_dots(qg, page_planes(phys), bits)  # [B,bits,Hq,bs]
        valid_b = valid[:, None, :].expand(B, Hq, bs)
        tok_alive = valid_b
        blk_live = valid.any(1)
        rounds = torch.zeros((B,), dtype=torch.int32, device=dev)
        for r in range(bits):
            rounds = rounds + blk_live.to(torch.int32)
            part = partials[:, r].float()
            lower = part + m_min[r][..., None]
            upper = part + m_max[r][..., None]
            low_here = torch.where(valid_b & tok_alive, lower, neg).amax(-1)
            mlow_new = torch.where(blk_live[:, None],
                                   torch.maximum(mlow, low_here), mlow)
            eta = mlow_new - alpha_radius
            if r < cfg.min_rounds - 1:
                keep = tok_alive & valid_b
            else:
                keep = tok_alive & (upper >= eta[..., None]) & valid_b
            keep = torch.where(blk_live[:, None, None], keep, tok_alive)
            blk_live = torch.where(blk_live, keep.any(2).any(1), blk_live)
            tok_alive = keep
            mlow = mlow_new

        survived = tok_alive & (rounds == bits)[:, None, None]
        any_surv = survived.any(2).any(1)
        logits = torch.where(
            survived, partials[:, bits - 1].float() * scale_total[..., None],
            neg)
        m_new = torch.maximum(m_run, logits.amax(-1))
        p = torch.where(survived, torch.exp(logits - m_new[..., None]),
                        torch.zeros_like(logits))
        corr = torch.where(m_run == NEG_INF, torch.zeros_like(m_run),
                           torch.exp(m_run - m_new))
        l_new = l_run * corr + p.sum(-1)
        vblk = v_pool[phys].float()                          # [B, bs, Hkv, dv]
        if cfg.quantize_v:
            vs = v_scale[None, None, :, None]
            v_eff = qlib.quantize_with_scale(vblk, vs, bits).float() * vs
        else:
            v_eff = vblk
        upd = torch.einsum("bkgt,btkd->bkgd", p.reshape(B, Hkv, G, bs), v_eff)
        acc_new = acc * corr[..., None] + upd.reshape(B, Hq, dv)
        gate = any_surv[:, None]
        m_run = torch.where(gate, m_new, m_run)
        l_run = torch.where(gate, l_new, l_run)
        acc = torch.where(gate[..., None], acc_new, acc)
        rounds_all.append(rounds)
        surv_all.append(survived)
        vf_all.append(any_surv)
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    survivors = torch.stack(surv_all, 2).reshape(B, Hq, MB * bs)
    return (out, torch.stack(rounds_all, 1), survivors,
            torch.stack(vf_all, 1))


def besf_attention_decode_paged(
    q: torch.Tensor,            # [B, Hq, d]: one decode query per slot
    k_pool: torch.Tensor,       # [P, page_size, Hkv, d] f32 or bf16 pool
    v_pool: torch.Tensor,       # [P, page_size, Hkv, dv] f32 or bf16 pool
    table: torch.Tensor,        # [B, MB] int32 block tables
    lengths: torch.Tensor,      # [B] int32 fill levels
    q_positions: torch.Tensor,  # [B] int32 absolute query positions
    k_amax: torch.Tensor,       # [Hkv] pool-wide running max|K|
    v_amax: torch.Tensor,       # [Hkv] pool-wide running max|V|
    cfg: BitStopperConfig = BitStopperConfig(),
    window: int | None = None,
) -> PagedDecodeOutput:
    """Paged BESF decode oracle in plain torch: planes are re-derived from
    the f32 K pool under the pool-wide scales, then walked with the exact
    page-sequential semantics of the kernel."""
    Hkv = k_pool.shape[2]
    prep = paged_decode_prep(q, k_amax, v_amax, Hkv, cfg)
    q_int, m_min, m_max, scale_total, alpha_radius, k_scale, v_scale = prep
    ks = k_scale[None, None, :, None]

    def page_planes(phys):
        k_int = qlib.quantize_with_scale(k_pool[phys].float(), ks, cfg.bits)
        return qlib.to_bitplanes(k_int, cfg.bits).transpose(0, 1)

    out, rounds, survivors, v_fetched = paged_decode_rows(
        q_int, m_min, m_max, scale_total, alpha_radius, table, lengths,
        q_positions, page_planes, v_pool, v_scale, cfg, window)
    return PagedDecodeOutput(out=out, rounds=rounds, survivors=survivors,
                             v_fetched=v_fetched)


class PagedVerifyOutput(NamedTuple):
    out: torch.Tensor        # [B, Sq, Hq, dv] attention output per query
    rounds: torch.Tensor     # [B, Sq, n_blocks] int32 planes fetched per page
    survivors: torch.Tensor | None  # [B, Sq, Hq, n_blocks*page_size] bool
    v_fetched: torch.Tensor | None  # [B, Sq, n_blocks] bool


def besf_attention_verify_paged(
    q: torch.Tensor,            # [B, Sq, Hq, d]: the draft block per slot
    k_pool: torch.Tensor,       # [P, page_size, Hkv, d] f32 or bf16 pool
    v_pool: torch.Tensor,       # [P, page_size, Hkv, dv] f32 or bf16 pool
    table: torch.Tensor,        # [B, MB] int32 block tables
    lengths: torch.Tensor,      # [B, Sq] int32 per-query fill levels
    q_positions: torch.Tensor,  # [B, Sq] int32 absolute query positions
    k_amax: torch.Tensor,       # [Hkv] pool-wide running max|K|
    v_amax: torch.Tensor,       # [Hkv] pool-wide running max|V|
    cfg: BitStopperConfig = BitStopperConfig(),
    window: int | None = None,
) -> PagedVerifyOutput:
    """Multi-query paged BESF verify oracle (speculative decoding).

    Every (slot, query) pair is an independent row of the Sq=1 paged
    decode: its own position, its own fill level (query i at position p
    sees cached tokens ``t_pos <= p``: earlier draft tokens, never later
    ones) and its own quantization and LATS thresholds.  The rows go
    through :func:`paged_decode_rows` with each slot's table broadcast to
    its queries, so a real draft query equals the Sq=1 decode at that
    position bit for bit.  A padding query has fill level 0 and touches
    no page."""
    B, Sq, Hq, d = q.shape
    MB = table.shape[1]
    flat = besf_attention_decode_paged(
        q.reshape(B * Sq, Hq, d), k_pool, v_pool,
        table[:, None].expand(B, Sq, MB).reshape(B * Sq, MB),
        lengths.reshape(B * Sq), q_positions.reshape(B * Sq), k_amax,
        v_amax, cfg, window)
    return PagedVerifyOutput(
        out=flat.out.reshape(B, Sq, Hq, -1),
        rounds=flat.rounds.reshape(B, Sq, MB),
        survivors=flat.survivors.reshape(B, Sq, Hq, -1),
        v_fetched=flat.v_fetched.reshape(B, Sq, MB))

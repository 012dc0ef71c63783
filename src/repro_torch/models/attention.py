"""Multi-head attention: the cache-free forward and the serving KV caches.

Counterpart of ``repro/models/attention.py`` for the cache-free forward
and the paths serving runs:

* the cache-free forward (``cache=None``) for every score path: ``xla``,
  chunked online-softmax attention in plain torch (``chunked_attention``;
  grouped GQA, no KV repetition; with the reference's manual backward,
  the training path); ``flash``, the dense CUDA
  kernel ``kernels/flash_attention``; ``bitstopper``, the fused BESF CUDA
  kernel ``kernels/bitstopper_qk``; ``bitstopper_xla``, the block oracle
  in plain torch.  The two kernel paths run their plain versions for CPU
  tensors;

* the contiguous caches (``init_cache`` without ``paged``): a shared-cursor
  cache (one ``length`` for the batch, ``dynamic_update_slice`` at
  ``length mod n_slots``), the per-slot layout of continuous batching
  (``length`` [B], ``pos`` [B, T], a scatter at ``(length + i) mod
  n_slots`` that drops pad tokens) and ring buffers of ``min(max_len,
  window)`` slots for sliding-window layers (``_update_cache``), read by
  ``_cached_attention``;
* the paged cache write (``_update_paged_cache``), which also keeps the
  pool-wide running quant scales and the packed bit-plane pool
  (``_update_plane_pool``);
* the decode read (``_paged_cached_attention``): one query per slot through
  the paged BESF decode, the CUDA kernel when ``fused_decode`` is set, else
  the plain torch oracle; with ``spec_verify``, a speculative draft block
  per slot through the paged BESF verify in the same way;
* mesh training: under training's rules (``sharding/rules.py:make_rules``)
  whose "model" dim splits the query heads, the cache-free forward runs
  Megatron's split (:func:`_train_split`): the rank's q heads and its KV
  heads (every KV head its q heads read, where "model" does not divide
  the KV heads, as MQA's one), the chunked attention per local head, and
  ``wo``'s rows summed over "model" (under sequence parallelism,
  reduce-scattered along the sequence: ``sharding/api.py:leave_model``);
* mesh serving: under serving rules (``sharding/``) whose "model" dim
  divides the KV heads, a rank's pools hold its KV heads, it writes every
  slot's K/V for them, and the paged reads run on its block of slots and
  heads (``_shard_paged_attention``), gathered back before ``wo``;
* every other paged read (prefill chunks, a planeless pool, whose page
  size is not a multiple of 8 and which carries no scales and no planes,
  and every read of a dense impl) gathers each row's logical view for
  ``_cached_attention``: block BitStopper (``_bitstopper_full``), the
  single-query or per-token BESF, or the dense masked softmax of ``xla``
  and ``flash`` (plain torch einsums, as the reference leaves it to XLA);
* the paged block-row transport (``extract_block_rows``,
  ``splice_block_rows``, ``requant_plane_pools``, ``repack_block_planes``,
  ``apply_inject_amax_rule``) under swap-to-host preemption and the
  persistent prefix store.

Every cache layout takes the K/V dtype (``ServeConfig.cache_dtype``: f32
or bf16; ``k_amax``/``v_amax`` stay f32).  A write rounds K/V to it, and
the scales and planes come from the rounded values widened; the score
paths read a bf16 view as the reference does (its quantization in bf16,
the dense softmax's weights rounded to bf16 before P x V), and host
records carry bf16 rows as their bits.

Four CUDA kernels sit under this module: ``flash_attention`` and
``bitstopper_qk`` on the cache-free forward, ``paged_decode`` and
``paged_verify`` on the serving reads.

The reference's immutable cache updates become in-place writes into the
pool tensors (the returned dict holds the same tensors): a decode tick then
moves only the written rows instead of copying every pool.  Where the
reference keeps an old cache by reference (the speculative growth
bailout), the port records what a write overwrites and puts it back
(``undo_paged_write``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.core import quantization as qlib
from repro_torch.core.besf import (BitStopperConfig,
                                   besf_attention_decode_paged,
                                   besf_attention_verify_paged)
from repro_torch.core.lats import NEG_INF
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.sharding.api import (block_index, current_rules,
                                      enter_model, gather_shards,
                                      leave_model, local_shard, local_view,
                                      model_split, training_rules)
from repro_torch.sharding.rules import splits_heads

POS_SENTINEL = 2 ** 30

# A write that grows a pool-wide running max-abs overshoots the new max by
# this factor, so growth (a whole-pool requant) happens a handful of times
# per serve instead of on every new maximum.
AMAX_HEADROOM = 1.25

_BITSTOPPER = ("bitstopper", "bitstopper_xla")


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int | None = None          # sliding-window size (None = global)
    causal: bool = True
    impl: str = "xla"
    bitstopper: BitStopperConfig = BitStopperConfig()
    chunk_q: int = 512                 # chunked_attention tiles
    chunk_k: int = 512
    fused_decode: bool = False         # paged decode through the CUDA kernel
    spec_verify: bool = False


def init_attention(generator, cfg: AttnConfig, device=None,
                   dtype=torch.float32):
    return {
        "wq": L.init_linear(generator, cfg.d_model,
                            (cfg.n_heads, cfg.head_dim), cfg.qkv_bias,
                            device, dtype),
        "wk": L.init_linear(generator, cfg.d_model,
                            (cfg.n_kv_heads, cfg.head_dim), cfg.qkv_bias,
                            device, dtype),
        "wv": L.init_linear(generator, cfg.d_model,
                            (cfg.n_kv_heads, cfg.head_dim), cfg.qkv_bias,
                            device, dtype),
        "wo": L.init_linear(generator, cfg.n_heads * cfg.head_dim,
                            cfg.d_model, False, device, dtype),
    }


def _mask_block(q_pos, k_pos, causal: bool, window: int | None):
    """[Sq, Sk] bool validity from absolute positions."""
    m = (k_pos[None, :] < POS_SENTINEL) & (q_pos[:, None] >= 0)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (the "xla" impl), grouped GQA
# ---------------------------------------------------------------------------


def _chunked_fwd(q, k, v, q_pos, k_pos, causal, window, cq, ck):
    """The reference's ``_fwd_impl`` at padded shapes: q [B, Sq, Hkv, G, D]
    grouped, k/v [B, Sk, Hkv, D] -> (out [B, Sq, Hkv, G, Dv] f32, lse [B,
    Hkv, G, Sq]).  ``lse`` is each row's log-sum-exp ``m + log l`` (0 for a
    row with no valid key), the normalizer the manual backward recomputes
    the probabilities from."""
    B, Sq, Hkv, G, D = q.shape
    Sk = k.shape[1]
    sm_scale = 1.0 / D ** 0.5
    outs, lses = [], []
    for q0 in range(0, Sq, cq):
        qc = q[:, q0:q0 + cq].float()
        m_run = torch.full((B, Hkv, G, cq), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros_like(m_run)
        acc = torch.zeros((B, Hkv, G, cq, v.shape[-1]), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Sk, ck):
            kc, vc = k[:, k0:k0 + ck].float(), v[:, k0:k0 + ck].float()
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * sm_scale
            mask = _mask_block(q_pos[q0:q0 + cq], k_pos[k0:k0 + ck], causal,
                               window)
            neg = torch.full_like(logits, NEG_INF)
            logits = torch.where(mask, logits, neg)
            m_new = torch.maximum(m_run, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            p = torch.where(mask, p, torch.zeros_like(p))
            corr = torch.where(m_run == NEG_INF, torch.zeros_like(m_run),
                               torch.exp(m_run - m_new))
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                       p, vc)
            m_run = m_new
        l_safe = torch.clamp(l_run, min=1e-30)
        out = acc / l_safe[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))            # [B,cq,Hkv,G,Dv]
        lses.append(torch.where(l_run > 0, m_run + torch.log(l_safe),
                                torch.zeros_like(l_run)))
    return torch.cat(outs, 1), torch.cat(lses, -1)


def _chunked_bwd(q, k, v, q_pos, k_pos, out, lse, dout, causal, window, cq,
                 ck):
    """The reference's manual flash-style backward (``_make_chunked_attn``'s
    ``bwd``): every tile's probabilities are recomputed from (q, k, lse),
    so nothing larger than one tile lives beyond O(S x D).  An outer loop
    over KV chunks carries ``dq``; an inner loop over Q chunks accumulates
    the chunk's ``dk``/``dv``, summed over the G query heads of each KV head.
    Masked pairs (causal, window, pad positions) get probability 0, so pad
    rows receive and give no gradient."""
    B, Sq, Hkv, G, D = q.shape
    Sk = k.shape[1]
    sm_scale = 1.0 / D ** 0.5
    dout = dout.float()
    # Per-row correction term delta_i = sum_d dout_i . out_i.
    delta = torch.einsum("bqhgd,bqhgd->bhgq", dout, out.float())
    qf = q.float()
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, Sk, ck):
        kc, vc = k[:, k0:k0 + ck].float(), v[:, k0:k0 + ck].float()
        dk_c = torch.zeros(kc.shape, dtype=torch.float32, device=q.device)
        dv_c = torch.zeros(vc.shape, dtype=torch.float32, device=q.device)
        dq_parts = []
        for q0 in range(0, Sq, cq):
            qi, doi = qf[:, q0:q0 + cq], dout[:, q0:q0 + cq]
            lsei, deli = lse[..., q0:q0 + cq], delta[..., q0:q0 + cq]
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qi, kc) * sm_scale
            mask = _mask_block(q_pos[q0:q0 + cq], k_pos[k0:k0 + ck], causal,
                               window)
            p = torch.where(mask, torch.exp(logits - lsei[..., None]),
                            torch.zeros_like(logits))
            dv_c = dv_c + torch.einsum("bhgqk,bqhgd->bkhd", p, doi)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doi, vc)
            ds = p * (dp - deli[..., None]) * sm_scale
            dq_parts.append(torch.einsum("bhgqk,bkhd->bqhgd", ds, kc))
            dk_c = dk_c + torch.einsum("bhgqk,bqhgd->bkhd", ds, qi)
        dq = dq + torch.cat(dq_parts, 1)
        dks.append(dk_c)
        dvs.append(dv_c)
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


class _ChunkedAttention(torch.autograd.Function):
    """Chunked attention with the manual backward (the reference's
    ``jax.custom_vjp``).  Autograd through the forward's loops would keep
    every tile's softmax; this saves only (q, k, v, positions, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, cq, ck):
        out, lse = _chunked_fwd(q, k, v, q_pos, k_pos, causal, window, cq,
                                ck)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.geometry = (causal, window, cq, ck)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = _chunked_bwd(q, k, v, q_pos, k_pos, out, lse, dout,
                                  *ctx.geometry)
        return dq, dk, dv, None, None, None, None, None, None


def chunked_attention(q, k, v, q_positions, k_positions, causal: bool,
                      window: int | None, chunk_q: int, chunk_k: int):
    """q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], positions [Sq] / [Sk] ->
    [B, Sq, Hq, Dv] in ``q.dtype``.  Sequences pad up to whole chunks; pad
    queries sit at position -1 and pad keys at ``POS_SENTINEL``, which
    every mask rejects.  Where a gradient is needed the call goes through
    the manual backward (:class:`_ChunkedAttention`)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    pad_q, pad_k = (-Sq) % cq, (-Sk) % ck
    F = torch.nn.functional
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_positions = F.pad(q_positions, (0, pad_q), value=-1)
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_positions = F.pad(k_positions, (0, pad_k), value=POS_SENTINEL)
    qg = q.reshape(B, q.shape[1], Hkv, G, D)
    if L.needs_grad(q, k, v):
        out = _ChunkedAttention.apply(qg, k, v, q_positions, k_positions,
                                      causal, window, cq, ck)
    else:
        out, _ = _chunked_fwd(qg, k, v, q_positions, k_positions, causal,
                              window, cq, ck)
    out = out.reshape(B, q.shape[1], Hq, v.shape[-1])
    return out[:, :Sq].to(q.dtype)


# ---------------------------------------------------------------------------
# BitStopper score path
# ---------------------------------------------------------------------------


def attention_block_shape(n: int, cap: int = 128) -> tuple[int, int]:
    """``(block, pad)``: tile ``min(cap, n)``, axis padded to a multiple."""
    b = min(cap, n)
    return b, (-n) % b


def _expand_gqa(q, k, v, G):
    """[B,S,H*,D] -> head-major [B,Hq,S,D] with KV heads repeated."""
    kr = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vr = v.repeat_interleave(G, dim=2).transpose(1, 2)
    return q.transpose(1, 2), kr, vr


def _bitstopper_full(q, k, v, cfg: AttnConfig, mask2d):
    """q [B,S,Hq,D], k/v [B,T,Hkv,D], mask2d [S,T] or None -> [B,S,Hq,D].

    Unmasked ``impl="bitstopper"`` runs the fused kernel over all (batch,
    head) slices unpadded, as the reference does: a length that its tiles
    do not fit raises ``ValueError``.  Everything else runs the block
    oracle with the sequence padded to whole tiles."""
    from repro_torch.core.block_adaptation import block_bitstopper_attention
    qt, kr, vr = _expand_gqa(q, k, v, cfg.n_heads // cfg.n_kv_heads)
    Sq, Sk = qt.shape[2], kr.shape[2]
    if cfg.impl == "bitstopper" and mask2d is None:
        out = kops.attention(qt, kr, vr, impl="bitstopper",
                             causal=cfg.causal, cfg=cfg.bitstopper)
        return out.transpose(1, 2).to(q.dtype)
    dev = q.device
    if mask2d is None and cfg.causal:
        mask2d = torch.tril(torch.ones((Sq, Sk), dtype=torch.bool,
                                       device=dev), diagonal=Sk - Sq)
    bq, pad_q = attention_block_shape(Sq)
    bk, pad_k = attention_block_shape(Sk)
    if pad_q or pad_k:
        if mask2d is None:
            mask2d = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
        mask2d = torch.nn.functional.pad(mask2d, (0, pad_k, 0, pad_q))
        qt = torch.nn.functional.pad(qt, (0, 0, 0, pad_q))
        kr = torch.nn.functional.pad(kr, (0, 0, 0, pad_k))
        vr = torch.nn.functional.pad(vr, (0, 0, 0, pad_k))
    res = block_bitstopper_attention(qt, kr, vr, cfg=cfg.bitstopper,
                                     block_q=bq, block_k=bk, mask=mask2d)
    return res.out.transpose(1, 2)[:, :Sq].to(q.dtype)


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """``pool_blocks`` physical blocks of ``page_size`` token slots, shared
    by every request through ``[batch, max_blocks_per_req]`` block tables.
    Physical block 0 is the null block: never written, it backs unused
    table entries."""
    pool_blocks: int
    page_size: int
    max_blocks_per_req: int

    def __post_init__(self):
        if self.pool_blocks < 2:
            raise ValueError("pool_blocks must be >= 2 (block 0 is the "
                             f"reserved null block), got {self.pool_blocks}")
        if self.page_size < 1 or self.max_blocks_per_req < 1:
            raise ValueError("page_size and max_blocks_per_req must be >= 1")


def init_cache(cfg: AttnConfig, batch: int, max_len: int | None = None,
               dtype=torch.float32, ring: bool = False,
               per_slot: bool = False, paged: PagedLayout | None = None,
               device=None):
    """A KV cache in one of the reference's layouts.

    Contiguous (no ``paged``): K/V ``[batch, n_slots, Hkv, D]`` with
    ``n_slots = min(max_len, window)`` for a ``ring`` (sliding-window) layer
    and ``max_len`` otherwise; writes go to ``length mod n_slots``.  With
    ``per_slot`` every row is a serving slot with its own cursor (``length``
    [batch]) and slot->position map (``pos`` [batch, n_slots]); otherwise
    the batch shares one cursor (``length`` a scalar, ``pos`` [n_slots]).

    Paged: batch-free ``[pool_blocks, page_size, Hkv, D]`` K/V pools,
    per-slot block ``table`` and fill ``length``.  BitStopper layers also
    carry the pool-wide running max-abs ``k_amax``/``v_amax`` and, with
    ``fused_decode``, the packed plane pool ``kq`` uint8[pool_blocks, bits,
    page_size//8, Hkv, D]."""
    if paged is None:
        n_slots = (min(max_len, cfg.window) if ring and cfg.window
                   else max_len)
        shape = (batch, n_slots, cfg.n_kv_heads, cfg.head_dim)
        lead = (batch,) if per_slot else ()
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full(lead + (n_slots,), POS_SENTINEL,
                              dtype=torch.int32, device=device),
            "length": torch.zeros(lead, dtype=torch.int32, device=device),
        }
    nb, bs = paged.pool_blocks, paged.page_size
    shape = (nb, bs, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((nb, bs), POS_SENTINEL, dtype=torch.int32,
                          device=device),
        "table": torch.zeros((batch, paged.max_blocks_per_req),
                             dtype=torch.int32, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if cfg.impl in _BITSTOPPER and bs % 8 == 0:
        cache["k_amax"] = torch.zeros((cfg.n_kv_heads,), dtype=torch.float32,
                                      device=device)
        cache["v_amax"] = torch.zeros((cfg.n_kv_heads,), dtype=torch.float32,
                                      device=device)
        if cfg.fused_decode:
            cache["kq"] = torch.zeros(
                (nb, cfg.bitstopper.bits, bs // 8, cfg.n_kv_heads,
                 cfg.head_dim), dtype=torch.uint8, device=device)
    return cache


def cache_is_paged(cache) -> bool:
    return "table" in cache


def cache_is_per_slot(cache) -> bool:
    return cache_is_paged(cache) or cache["pos"].ndim == 2


def _update_cache(cache, k, v, positions):
    """Write new token(s) into a contiguous cache, in place; returns (k,
    v, pos, new cache).

    Per-slot: a scatter at ``(length[b] + i) mod n_slots``; pad-sentinel
    tokens (trailing bucket padding) are dropped and never advance the
    cursor.  Shared cursor: the block lands at ``length mod n_slots``, its
    start clamped so that it fits, as ``dynamic_update_slice`` clamps it.
    The reference's ``shard_map`` write for a cache sharded along its
    sequence over "model" belongs to training's rules (``kv_seq`` in
    ``AXIS_MAP_1POD``; ROADMAP A10, training); the serving rules never
    shard a contiguous cache, and mesh serving refuses the contiguous
    engines."""
    S = k.shape[1]
    n_slots = cache["k"].shape[1]
    kc = k.to(cache["k"].dtype)
    vc = v.to(cache["v"].dtype)
    pc = positions.to(torch.int32)
    if cache_is_per_slot(cache):
        B = kc.shape[0]
        pc2 = torch.broadcast_to(pc, (B, S))
        real = pc2 != POS_SENTINEL
        idx = torch.remainder(
            cache["length"][:, None]
            + torch.arange(S, dtype=torch.int32, device=pc.device)[None],
            n_slots).long()
        rows = torch.arange(B, device=pc.device)[:, None].expand(B, S)
        sel = (rows[real], idx[real])
        cache["k"].index_put_(sel, kc[real])
        cache["v"].index_put_(sel, vc[real])
        cache["pos"].index_put_(sel, pc2[real])
        new = dict(cache, length=cache["length"]
                   + real.sum(1, dtype=torch.int32))
        return cache["k"], cache["v"], cache["pos"], new
    widx = int(cache["length"]) % n_slots
    start = min(max(widx, 0), n_slots - S)
    cache["k"][:, start:start + S] = kc
    cache["v"][:, start:start + S] = vc
    cache["pos"][start:start + S] = pc
    new = dict(cache, length=cache["length"] + S)
    return cache["k"], cache["v"], cache["pos"], new


def _put_rows(dst: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
              val: torch.Tensor) -> None:
    """``dst[idx[i]] = val[i]`` for ``ok[i]``, in place and without a host
    sync.  A dropped write is sent to row 0 (slot 0 of the null block,
    which no real write targets) and stores that row's current value."""
    idx = torch.where(ok, idx, torch.zeros_like(idx))
    keep = dst[idx]
    okb = ok.reshape((-1,) + (1,) * (val.ndim - 1))
    dst.index_put_((idx,), torch.where(okb, val.to(dst.dtype), keep))


def _update_plane_pool(cache, kc, vc, real, phys, p_safe, ok):
    """Keep the pool-wide scales and, with ``kq`` present, the packed plane
    pool at write time.

    ``k_amax``/``v_amax`` are the monotone running max-abs per KV head.
    While they hold, only the new tokens are quantized and their bits
    merged into ``kq``; when a write grows ``k_amax``, every stored plane
    is stale and the whole pool is requantized from the K pool.  The
    growth test is a host branch: one device-to-host sync per layer per
    write.  Under a mesh it reads this rank's KV heads only, so ranks may
    branch apart here; that is right per head (``pack_pool_planes`` is a
    function of the K pool and the scales alone, so a head whose scale
    held gets its bytes back unchanged), and no host counter reads the
    branch: a count of requants would need the max over "model".

    Packing: token at page offset ``t`` owns bit ``t % 8`` of byte
    ``t // 8``.  Pages fill front to back, so a write at bit ``b`` keeps
    the bits below ``b`` (earlier tokens) and clears those above."""
    k_amax, v_amax = cache["k_amax"], cache["v_amax"]
    undo = cache.get("undo")
    realm = real[..., None, None]
    k_hi = (kc.float().abs() * realm).amax(dim=(0, 1, 3))
    v_hi = (vc.float().abs() * realm).amax(dim=(0, 1, 3))
    k_amax_new = torch.where(k_hi > k_amax, k_hi * AMAX_HEADROOM, k_amax)
    v_amax_new = torch.where(v_hi > v_amax, v_hi * AMAX_HEADROOM, v_amax)
    if "kq" not in cache:
        return dict(k_amax=k_amax_new, v_amax=v_amax_new)
    kq = cache["kq"]
    nb, bits, bs8, H, D = kq.shape
    bs = bs8 * 8
    if bool((k_amax_new > k_amax).any()):
        if undo is not None:
            undo[-1]["kq"] = kq.clone()
        kq.copy_(qlib.pack_pool_planes(cache["k"], k_amax_new, bits))
        return dict(kq=kq, k_amax=k_amax_new, v_amax=v_amax_new)
    k_scale = qlib.scale_from_amax(k_amax_new, bits)
    k_int = qlib.quantize_with_scale(kc.float(),
                                     k_scale[None, None, :, None], bits)
    u = torch.where(k_int < 0, k_int + (1 << bits), k_int)
    shifts = torch.arange(bits - 1, -1, -1, dtype=torch.int32,
                          device=kq.device).reshape(1, bits, 1, 1)
    off = p_safe % bs
    byte, bitpos = (off // 8).long(), off % 8
    row = torch.where(ok, phys, torch.zeros_like(phys)).long()
    if undo is not None:
        undo[-1]["kq_at"] = (row, byte, kq[row, :, byte].clone())
    # One token at a time: tokens of one chunk share bytes, and each write
    # must see the bits its predecessors left.
    for s in range(real.shape[1]):
        r, by, bp = row[:, s], byte[:, s], bitpos[:, s][:, None, None, None]
        tokbits = (u[:, s, None] >> shifts) & 1                  # [B,bits,H,D]
        old = kq[r, :, by].to(torch.int32)                       # [B,bits,H,D]
        new = (old & ((1 << bp) - 1)) | (tokbits << bp)
        new = torch.where(ok[:, s, None, None, None], new, old)
        kq[r, :, by] = new.to(torch.uint8)
    return dict(kq=kq, k_amax=k_amax_new, v_amax=v_amax_new)


def _update_paged_cache(cache, k, v, positions):
    """Write new token(s) through the block table; returns the new cache.

    A token at absolute position p lives in logical block p // bs at offset
    p % bs.  Writes never target physical block 0, and pad-sentinel tokens
    are dropped.

    The pools are written in place.  A cache that carries an ``undo`` list
    (a speculative verify write) gets a record appended of everything the
    write overwrites in them, which :func:`undo_paged_write` puts back.
    The returned ``length`` and amax leaves are new tensors, so keeping
    the old ones undoes the rest."""
    nb, bs = cache["pos"].shape
    B, S = k.shape[:2]
    kc = k.to(cache["k"].dtype)
    vc = v.to(cache["v"].dtype)
    pc2 = torch.broadcast_to(positions.to(torch.int32), (B, S))
    table = cache["table"]
    MB = table.shape[1]
    real = pc2 != POS_SENTINEL
    p_safe = torch.where(real, pc2, torch.zeros_like(pc2))
    logical = p_safe // bs
    phys = torch.gather(table, 1, logical.clamp(0, MB - 1).long())
    ok = real & (logical < MB) & (phys > 0)
    flat = (phys * bs + p_safe % bs).long().reshape(-1)
    okf = ok.reshape(-1)
    H, D = kc.shape[2], kc.shape[3]
    if "undo" in cache:
        at = torch.where(okf, flat, torch.zeros_like(flat))
        cache["undo"].append({"rows": at, **{
            key: cache[key].view((nb * bs,) + cache[key].shape[2:])[at].clone()
            for key in ("k", "v", "pos")}})
    _put_rows(cache["k"].view(nb * bs, H, D), flat, okf, kc.reshape(-1, H, D))
    _put_rows(cache["v"].view(nb * bs, H, vc.shape[3]), flat, okf,
              vc.reshape(-1, H, vc.shape[3]))
    _put_rows(cache["pos"].view(nb * bs), flat, okf, pc2.reshape(-1))
    new = dict(cache, length=cache["length"]
               + real.sum(1, dtype=torch.int32))
    if "k_amax" in cache:
        new.update(_update_plane_pool(cache, kc, vc, real, phys, p_safe, ok))
    return new


def undo_paged_write(cache, record) -> None:
    """Put back, in place, what one recorded ``_update_paged_cache`` wrote
    into the pools of ``cache``: the K/V/pos rows and the plane-pool bytes
    (the whole ``kq`` when the write requantized it)."""
    nb, bs = cache["pos"].shape
    for key in ("k", "v", "pos"):
        flat = cache[key].view((nb * bs,) + cache[key].shape[2:])
        flat.index_put_((record["rows"],), record[key])
    if "kq" in record:
        cache["kq"].copy_(record["kq"])
    elif "kq_at" in record:
        row, byte, old = record["kq_at"]
        cache["kq"][row, :, byte] = old


def gather_paged_view(cache, active=None):
    """Each row's dense logical view ``[B, MB*bs]`` gathered from the pool;
    slots past the fill level are invalid and zeroed.  ``active`` ([B]
    bool) swaps an inactive row's table for the null block."""
    nb, bs = cache["pos"].shape
    table = cache["table"]
    if active is not None:
        table = torch.where(active[:, None], table, torch.zeros_like(table))
    B, MB = table.shape
    Tv = MB * bs
    dev = table.device
    view = (table[..., None].long() * bs
            + torch.arange(bs, device=dev)).reshape(B, Tv)
    k_view = cache["k"].reshape((nb * bs,) + cache["k"].shape[2:])[view]
    v_view = cache["v"].reshape((nb * bs,) + cache["v"].shape[2:])[view]
    pos_view = cache["pos"].reshape(nb * bs)[view]
    valid = torch.arange(Tv, device=dev)[None] < cache["length"][:, None]
    pos_view = torch.where(valid, pos_view,
                           torch.full_like(pos_view, POS_SENTINEL))
    vm = valid[..., None, None]
    k_view = torch.where(vm, k_view, torch.zeros_like(k_view))
    v_view = torch.where(vm, v_view, torch.zeros_like(v_view))
    return k_view, v_view, pos_view


def _paged_shard_rules(cfg: AttnConfig):
    """The active rules iff the paged pools are split over KV heads under
    them (``sharding/rules.py:splits_heads``).  Otherwise (MQA's one KV
    head on two ranks) the pools are whole on every rank and the
    single-device read is already right."""
    rules = current_rules()
    if rules is None or not splits_heads(rules, cfg.n_kv_heads):
        return None
    return rules


def _shard_paged_attention(fn, rules, q, kpool, vpool, table, lengths,
                           q_pos, k_amax, v_amax):
    """A paged BESF call on this rank's block: its slots over "data" and
    its KV heads over "model", then the block gathered back.

    Every BESF quantity (LATS thresholds, plane partials, the softmax
    normalizer, the V sum) reduces within one (slot, KV head), and the
    grouped query heads go with their KV head (heads are KV-major), so the
    block's ``out`` is bit for bit the single-device ``out`` there; the
    gather is data movement, and ``wo`` then sums in single-device order.
    The pools and scales are this rank's already (the engine placed them);
    ``q`` and the per-slot operands are full and sliced here.  Only ``out``
    leaves the shard, so the slot-wide ``rounds`` (a max over KV heads)
    never meets one.  A slot count "data" does not divide replicates the
    slots."""
    verify = q.ndim == 4                                  # [B, Sq, Hq, D]
    b = rules.pspec(("batch",), (q.shape[0],))[0]
    qspec = (b, None, "model", None) if verify else (b, "model", None)
    lspec = (b, None) if verify else (b,)
    out = fn(local_shard(rules, q, qspec), kpool, vpool,
             local_shard(rules, table, (b, None)),
             local_shard(rules, lengths, lspec),
             local_shard(rules, q_pos, lspec), k_amax, v_amax).out
    return gather_shards(rules, out, qspec)


def _paged_cached_attention(q, cache, positions, cfg: AttnConfig):
    """Attention against the (already updated) paged cache.

    A verify draft block or one query per slot with BitStopper goes
    straight at the pool: the CUDA kernel when ``cfg.fused_decode``, else
    the plain oracle.  Prefill chunks and every read of a planeless pool
    gather the logical view of the active rows.  Under mesh rules that
    split the pools (:func:`_paged_shard_rules`) the pool reads run on this
    rank's block (:func:`_shard_paged_attention`), and a gathered view
    holds this rank's KV heads, read by their query heads for every slot
    and gathered over "model"."""
    B, S = q.shape[:2]
    active = (positions != POS_SENTINEL).any(1)
    rules = _paged_shard_rules(cfg)
    call = None
    if cfg.spec_verify and cfg.impl in _BITSTOPPER and "k_amax" in cache:
        # Speculative verify: the whole draft block in one paged pass.  The
        # write has already placed the draft tokens, so query i with fill
        # level position + 1 sees exactly what the Sq=1 decode at that
        # position sees.  Padding queries get fill level 0.
        real = positions != POS_SENTINEL
        q_pos = torch.where(real, positions, torch.zeros_like(positions))
        lengths = torch.where(real, q_pos + 1, torch.zeros_like(q_pos))
        qt = q
        if cfg.fused_decode:
            from repro_torch.kernels.paged_verify import \
                paged_bitstopper_verify as call
        else:
            call = besf_attention_verify_paged
    elif cfg.impl in _BITSTOPPER and S == 1 and "k_amax" in cache:
        qt = q[:, 0]
        q_pos = positions[:, 0]
        # A slot still prefilling decodes at the pad sentinel; fill level 0
        # makes all of its pages unreachable.
        lengths = torch.where(active, cache["length"],
                              torch.zeros_like(cache["length"]))
        if cfg.fused_decode:
            from repro_torch.kernels.paged_decode import \
                paged_bitstopper_decode as call
        else:
            call = besf_attention_decode_paged
    if call is not None:
        pool = cache["kq"] if cfg.fused_decode else cache["k"]
        args = (qt, pool, cache["v"], cache["table"], lengths, q_pos,
                cache["k_amax"], cache["v_amax"])
        kw = {"stats": False} if cfg.fused_decode else {}
        fn = functools.partial(call, cfg=cfg.bitstopper, window=cfg.window,
                               **kw)
        out = (_shard_paged_attention(fn, rules, *args) if rules is not None
               else fn(*args).out)
        out = out if qt.ndim == 4 else out[:, None]
        return out.to(q.dtype)                                # [B,S,Hq,Dv]
    k_view, v_view, pos_view = gather_paged_view(cache, active)
    if rules is None:
        return _cached_attention(q, k_view, v_view, positions, pos_view, cfg)
    spec = rules.pspec((None, None, "heads", None), q.shape)
    out = _cached_attention(local_shard(rules, q, spec), k_view, v_view,
                            positions, pos_view, cfg)
    return gather_shards(rules, out, spec)


def _cached_attention(q, k_all, v_all, q_positions, k_positions,
                      cfg: AttnConfig):
    """Attention of q [B, Sq, Hq, D] against a contiguous cache or each
    row's gathered paged view, masked from slot positions: 1-D (a
    shared-cursor cache, one mask for the batch) or 2-D [B, ...] (every row
    masked by its own positions).

    BitStopper: one query per row runs the single-query BESF; a shared
    cursor or one row's prefill chunk runs block BitStopper; several
    queries in several rows (a verify forward on a planeless pool) the
    per-token BESF.  ``xla`` and ``flash``: the dense masked softmax with
    grouped heads, ``/ sqrt(D)``, masked logits at ``NEG_INF`` and masked
    weights zeroed, in f32; the weights round to the cache's dtype before
    P x V, as the reference's mixed-dtype einsum rounds them (a bf16 cache:
    bf16 weights, whose products with bf16 V are exact in f32)."""
    B, Sq = q.shape[:2]
    per_slot = q_positions.ndim == 2
    if per_slot:
        mask = torch.stack([_mask_block(qp, kp, causal=True,
                                        window=cfg.window)
                            for qp, kp in zip(q_positions, k_positions)])
        bmask = mask                                         # [B, Sq, T]
    else:
        mask = _mask_block(q_positions, k_positions, causal=True,
                           window=cfg.window)               # [Sq, T]
        bmask = mask[None].expand((B,) + mask.shape)
    if cfg.impl in _BITSTOPPER:
        if Sq > 1 and (not per_slot or B == 1):
            return _bitstopper_full(q, k_all, v_all, cfg,
                                    mask if not per_slot else mask[0])
        from repro_torch.core.besf import (besf_attention,
                                           besf_attention_decode)
        qt, kr, vr = _expand_gqa(q, k_all, v_all,
                                 cfg.n_heads // cfg.n_kv_heads)
        besf = besf_attention_decode if Sq == 1 else besf_attention
        res = besf(qt, kr, vr, cfg=cfg.bitstopper, mask=bmask[:, None])
        return res.out.transpose(1, 2).to(q.dtype)
    G = cfg.n_heads // cfg.n_kv_heads
    _, T, Hkv, D = k_all.shape
    qg = q.reshape(B, Sq, Hkv, G, D)
    # A true division by sqrt(D), as the reference's: a 0-dim tensor on the
    # logits' device (a Python scalar becomes a reciprocal multiply on CUDA).
    scale = torch.tensor(D ** 0.5, dtype=torch.float32, device=q.device)
    logits = torch.einsum("bqhgd,bthd->bhgqt", qg.float(),
                          k_all.float()) / scale
    bm = bmask[:, None, None]
    logits = torch.where(bm, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(bm, p, torch.zeros_like(p)).to(v_all.dtype)
    out = torch.einsum("bhgqt,bthd->bqhgd", p.float(), v_all.float())
    return out.reshape(q.shape).to(q.dtype)


# ---------------------------------------------------------------------------
# Public layer
# ---------------------------------------------------------------------------


def attention(p, x: torch.Tensor, positions: torch.Tensor, cfg: AttnConfig,
              cache: dict[str, Any] | None = None):
    """Returns (out [B,S,d_model], new_cache).

    ``positions`` is [S] (shared across the batch) or, with a per-slot or
    paged cache, [B, S] (each slot at its own absolute position; pad rows
    at ``POS_SENTINEL``).  A speculative verify (``cfg.spec_verify``) runs
    the projections position by position (``layers.by_column``)."""
    B, S, _ = x.shape
    tp = _train_split(cfg, cache)
    if tp is not None:
        rules, group, cfg = tp
        x = enter_model(x, rules)
    if cache is not None and cache_is_per_slot(cache) and \
            positions.ndim == 1:
        positions = positions[None].expand(B, S)
    split = cfg.spec_verify and cache is not None
    q = L.by_column(lambda t: L.linear(p["wq"], t), x, split)  # [B,S,Hq,D]
    k = L.by_column(lambda t: L.linear(p["wk"], t), x, split)  # [B,S,Hkv,D]
    v = L.by_column(lambda t: L.linear(p["wv"], t), x, split)
    if tp is not None and group:
        # "model" does not divide the KV heads (they are whole on every
        # rank): each local q head reads its group's KV head.
        m = block_index(rules, "model")[0]
        heads = torch.arange(m * cfg.n_heads, (m + 1) * cfg.n_heads,
                             device=k.device) // group
        k, v = k.index_select(2, heads), v.index_select(2, heads)
    rope_pos = positions if positions.ndim == 2 else positions[None, :]
    q = L.rope(q, rope_pos, cfg.rope_theta)
    k = L.rope(k, rope_pos, cfg.rope_theta)
    if positions.ndim == 2:
        # Zero pad rows: their K/V writes are dropped, and zero q rows keep
        # the per-tensor quant scale independent of bucket padding.
        real = (positions != POS_SENTINEL)[..., None, None]
        q, k, v = q * real, k * real, v * real

    if cache is None:
        if positions.ndim == 2:
            positions = positions[0]
        if cfg.impl in _BITSTOPPER:
            mask2d = None
            if cfg.window is not None:
                mask2d = _mask_block(positions, positions, cfg.causal,
                                     cfg.window)
            out = _bitstopper_full(q, k, v, cfg, mask2d)
        elif cfg.impl == "flash" and cfg.window is None:
            qt, kr, vr = _expand_gqa(q, k, v, cfg.n_heads // cfg.n_kv_heads)
            out = kops.attention(qt, kr, vr, impl="flash",
                                 causal=cfg.causal).transpose(1, 2)
        else:
            out = chunked_attention(q, k, v, positions, positions,
                                    causal=cfg.causal, window=cfg.window,
                                    chunk_q=cfg.chunk_q,
                                    chunk_k=cfg.chunk_k)
        new_cache = None
    elif cache_is_paged(cache):
        rules = _paged_shard_rules(cfg)
        if rules is not None:
            # This rank's pools hold its KV heads; it writes every slot's
            # K/V for them (the pools are replicated over "data").
            spec = rules.pspec((None, None, "kv_heads", None), k.shape)
            k, v = local_shard(rules, k, spec), local_shard(rules, v, spec)
        new_cache = _update_paged_cache(cache, k, v, positions)
        out = _paged_cached_attention(q, new_cache, positions, cfg)
    else:
        k_all, v_all, k_pos, new_cache = _update_cache(cache, k, v,
                                                       positions)
        out = _cached_attention(q, k_all, v_all, positions, k_pos, cfg)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    y = L.by_column(lambda t: L.linear(p["wo"], t), out, split)
    if cache is None:
        y = leave_model(y, training_rules(), partial=tp is not None)
    return y, new_cache


def _train_split(cfg: AttnConfig, cache):
    """``(rules, group, local cfg)`` where training's rules split this
    layer's q heads over "model" (``sharding/api.py:model_split`` of
    ``wq``), else None.  The local cfg counts the rank's q heads and its
    KV heads: its block where the rules split them too (``group`` 0), else
    one per q head (``group`` the q heads per KV head; :func:`attention`
    picks each q head's)."""
    rules = training_rules()
    d, hd = cfg.d_model, cfg.head_dim
    if rules is None or not model_split(rules, "attn/wq/w",
                                        (d, cfg.n_heads, hd), 1):
        return None
    if cache is not None:
        raise ValueError("training's rules split the attention heads of a "
                         "cache-free forward only")
    tp = rules.shape["model"]
    hl = cfg.n_heads // tp
    whole = not model_split(rules, "attn/wk/w", (d, cfg.n_kv_heads, hd), 1)
    return (rules, cfg.n_heads // cfg.n_kv_heads if whole else 0,
            dataclasses.replace(cfg, n_heads=hl, n_kv_heads=hl if whole
                                else cfg.n_kv_heads // tp))


# ---------------------------------------------------------------------------
# Paged block-row transport: the device<->host seam of the memory hierarchy
# ---------------------------------------------------------------------------
#
# These helpers move whole physical blocks between the paged pools and host
# arrays; swap-to-host preemption and the persistent prefix store are built
# on them.  A record lists the layers in the reference's layout, so that
# stores cross between the packages: one entry per paged layer of the
# reference, where a segment the reference stacks (``scan_layers`` and more
# than one rep) is one entry whose arrays carry a leading reps axis.  The
# port keeps one cache dict per layer, so each entry maps to the list of
# layer dicts it holds (:func:`paged_layer_groups`).  Splices write the pool
# tensors in place; records are host copies, never views of a pool.
#
# Under a mesh whose "model" dim splits the KV heads, a rank's pools hold its
# heads.  Given those ``rules`` (``heads=``), the transport speaks whole
# records, the bytes a single-device engine moves: an extract gathers the
# heads (one all-gather a field), a splice and the inject scale rule take
# this rank's heads of a whole record.  Without it a record holds what the
# pools hold (a rank's private swap records).

_HEAD_FIELDS = ("k", "v", "kq")       # their heads axis is the second last


def heads_spec(ndim: int, axis: int = -2) -> tuple:
    """The spec of an array whose axis ``axis`` is the KV heads, split over
    "model": a record's K/V/planes (the second last axis), a scale leaf
    (``axis=-1``)."""
    spec = [None] * ndim
    spec[axis] = "model"
    return tuple(spec)


def paged_layer_groups(caches, scan_layers: bool = True) -> list[list[dict]]:
    """The reference's paged layers in its sorted-key traversal of the
    cache tree, each as the list of the port's layer caches it holds: the
    reps of a segment the reference stacks, else one layer."""
    groups = []
    for seg in sorted(caches):
        units = caches[seg]
        stacked = scan_layers and len(units) > 1
        for reps in ([units] if stacked else [[u] for u in units]):
            for b in sorted(reps[0]):
                if cache_is_paged(reps[0][b]):
                    groups.append([u[b] for u in reps])
    return groups


def host_array(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array; bf16 (which numpy lacks) as its raw bits,
    uint16.  A record's K/V field of 2-byte values always holds bf16
    bits."""
    if t.dtype == torch.bfloat16:
        return t.cpu().view(torch.int16).numpy().view(np.uint16)
    return t.cpu().numpy()


def _bf16_bits(a: np.ndarray) -> bool:
    """Whether a host K/V array holds bf16 bits: 2-byte unsigned, or the
    2-byte void type that ``np.load`` gives a stored bf16 array."""
    return a.dtype.itemsize == 2 and a.dtype.kind in "uV"


def host_f32(a) -> np.ndarray:
    """Host K/V rows widened to f32 (bf16 bits exactly)."""
    a = np.asarray(a)
    if _bf16_bits(a):
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def tensor_from_host(a, device=None) -> torch.Tensor:
    """The inverse of :func:`host_array`: bf16 bits (also the 2-byte void
    arrays that ``np.load`` and ml_dtypes give a bf16 array) become a bf16
    tensor, any other array a tensor of its dtype."""
    a = np.asarray(a)
    if _bf16_bits(a):
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def _host_rows(group, field, idx, heads=None):
    """Rows ``idx`` of one field of a layer group as a host array: stacked
    over the group's reps when it has several, and with ``heads`` gathered
    to every KV head.  Indexing with a tensor gathers into new storage, so
    the array is a copy, never a view of the pool (``numpy()`` of a CPU
    tensor shares its memory)."""
    rows = [c[field][idx] for c in group]
    t = torch.stack(rows) if len(group) > 1 else rows[0]
    if heads is not None and field in _HEAD_FIELDS:
        t = gather_shards(heads, t, heads_spec(t.ndim))
    return host_array(t)


def extract_block_rows(caches, bids, planes: bool = False,
                       scan_layers: bool = True, heads=None) -> list[dict]:
    """Device-to-host copy of the physical blocks ``bids`` from every paged
    layer: one dict per reference paged layer with the ``k``/``v`` rows
    (f32, or a bf16 cache's bits as uint16) and the ``pos`` plane
    (``[reps, n, ...]`` for a stacked entry, else ``[n, ...]``) and, with
    ``planes`` and a plane pool, the packed ``kq`` rows.  With ``heads``
    (the mesh rules under which the pools hold this rank's KV heads) the
    rows are gathered whole, on every rank.  Full blocks are never
    rewritten, so the rows stay valid until the block is freed and
    reused."""
    groups = paged_layer_groups(caches, scan_layers)
    idx = torch.as_tensor(list(bids), dtype=torch.long,
                          device=groups[0][0]["k"].device)
    layers = []
    for group in groups:
        fields = ("k", "v", "pos")
        if planes and "kq" in group[0]:
            fields += ("kq",)
        layers.append({f: _host_rows(group, f, idx, heads) for f in fields})
    return layers


def splice_block_rows(caches, bids, layers, sel=None,
                      scan_layers: bool = True, heads=None):
    """Write rows from :func:`extract_block_rows` into the physical blocks
    ``bids`` of every paged layer, in place.  ``sel`` picks which record
    rows feed which block (``bids[i] <- rows[sel[i]]``; by default all rows
    in order).  ``kq`` rows are written only where both the record and the
    cache carry them: a caller whose scales moved since the extraction
    strips them and repacks instead (:func:`repack_block_planes`).  With
    ``heads`` the record is whole and this rank's KV heads of it are
    written.  Returns ``caches``."""
    groups = paged_layer_groups(caches, scan_layers)
    if len(layers) != len(groups):
        raise ValueError(f"record holds {len(layers)} paged layers, the "
                         f"cache {len(groups)}")
    idx = torch.as_tensor(list(bids), dtype=torch.long,
                          device=groups[0][0]["k"].device)
    for group, rows in zip(groups, layers):
        for field in ("k", "v", "pos", "kq"):
            if field not in rows or field not in group[0]:
                continue
            # Converted as the reference's ``astype`` converts (bf16 to
            # f32 exactly, f32 to bf16 to nearest even).
            dst = group[0][field]
            val = tensor_from_host(rows[field])
            if heads is not None and field in _HEAD_FIELDS:
                val = local_view(heads, val, heads_spec(val.ndim))
            val = val.to(device=dst.device, dtype=dst.dtype)
            if len(group) == 1:
                val = val[None]
            if sel is not None:
                val = val[:, list(sel)]
            for c, v in zip(group, val):
                c[field][idx] = v
    return caches


def requant_plane_pools(caches):
    """Rebuild every packed plane pool from its K pool under the current
    scales, in place: the fix-up after an operation that moved ``k_amax``
    under stored planes.  ``pack_pool_planes`` is a function of (K pool,
    amax) alone, so the bytes equal an incrementally kept pool whose last
    requant happened at these scales.  Returns ``caches``."""
    for group in paged_layer_groups(caches):
        for c in group:
            if "kq" in c:
                c["kq"].copy_(qlib.pack_pool_planes(
                    c["k"], c["k_amax"], c["kq"].shape[1]))
    return caches


def repack_block_planes(caches, bids):
    """Rebuild the packed planes of the blocks ``bids`` alone from their
    (just spliced) f32 rows under the current scales, in place: equal to
    the write rule quantizing the same tokens under the same unchanged
    scale.  Returns ``caches``."""
    for group in paged_layer_groups(caches):
        for c in group:
            if "kq" in c:
                idx = torch.as_tensor(list(bids), dtype=torch.long,
                                      device=c["kq"].device)
                c["kq"][idx] = qlib.pack_pool_planes(
                    c["k"][idx], c["k_amax"], c["kq"].shape[1])
    return caches


def apply_inject_amax_rule(caches, layers, groups, scan_layers: bool = True,
                           heads=None):
    """Replay the cache write's scale rule for injected rows, once per
    chunk group: the trajectory chunked prefill of the same tokens takes.

    ``layers`` pairs with the reference's paged layers (an
    :func:`extract_block_rows` result); ``groups`` is a list of chunk
    groups, each a list of ``(row, lo, hi)``: a record row and the token
    window of that block inside the group.  Host numpy, as in the
    reference: ``abs`` and ``max`` are exact and the f32 multiply by
    ``AMAX_HEADROOM`` rounds as the device rule's in
    :func:`_update_plane_pool`.  The scales are written back in place.

    With ``heads`` the records are whole and the rule runs on this rank's
    KV heads of them (every quantity is per head), against its scales.

    Returns ``(caches, k_grew)``; ``k_grew`` says whether any K scale moved,
    in which case the caller requantizes every plane pool
    (:func:`requant_plane_pools`), else repacks the injected blocks.  Under
    a mesh it is this rank's answer; the caller makes the ranks agree."""
    headroom = np.float32(AMAX_HEADROOM)
    k_grew = False

    def window_hi(rows, stacked, row, lo, hi):
        if stacked:                       # [reps, nrows, bs, H, D]
            w = np.abs(rows[:, row, lo:hi])
            return w.max(axis=(1, 3), initial=np.float32(0.0))
        w = np.abs(rows[row, lo:hi])      # [hi-lo, H, D]
        return w.max(axis=(0, 2), initial=np.float32(0.0))

    for group, rows in zip(paged_layer_groups(caches, scan_layers), layers):
        if "k_amax" not in group[0]:
            continue
        stacked = len(group) > 1
        k_rows = host_f32(rows["k"])
        v_rows = host_f32(rows["v"])
        if heads is not None:
            k_rows, v_rows = (local_view(heads, torch.from_numpy(a),
                                         heads_spec(a.ndim)).numpy()
                              for a in (k_rows, v_rows))
        k_amax = np.stack([c["k_amax"].cpu().numpy() for c in group])
        v_amax = np.stack([c["v_amax"].cpu().numpy() for c in group])
        if not stacked:
            k_amax, v_amax = k_amax[0], v_amax[0]
        k0, v0 = k_amax.copy(), v_amax.copy()
        for wins in groups:
            k_hi = np.zeros(k_amax.shape, np.float32)
            v_hi = np.zeros(v_amax.shape, np.float32)
            for row, lo, hi in wins:
                k_hi = np.maximum(k_hi, window_hi(k_rows, stacked, row,
                                                  lo, hi))
                v_hi = np.maximum(v_hi, window_hi(v_rows, stacked, row,
                                                  lo, hi))
            k_new = np.where(k_hi > k_amax, k_hi * headroom, k_amax)
            v_new = np.where(v_hi > v_amax, v_hi * headroom, v_amax)
            if (k_new > k_amax).any():
                k_grew = True
            k_amax = k_new.astype(np.float32)
            v_amax = v_new.astype(np.float32)
        if (k_amax == k0).all() and (v_amax == v0).all():
            continue
        k_amax = k_amax.reshape((len(group),) + k_amax.shape[-1:])
        v_amax = v_amax.reshape((len(group),) + v_amax.shape[-1:])
        for c, ka, va in zip(group, k_amax, v_amax):
            c["k_amax"].copy_(torch.as_tensor(ka))
            c["v_amax"].copy_(torch.as_tensor(va))
    return caches, k_grew

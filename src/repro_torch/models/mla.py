"""Multi-head Latent Attention (DeepSeek-V3).

Counterpart of ``repro/models/mla.py``.  Queries and KV are low-rank
compressed; the cache stores only the latent ``c_kv`` [S, kv_rank] and
the decoupled RoPE key [S, rope_dim].

* The cache-free forward expands the latents into per-head K/V and runs
  chunked attention (``attention.chunked_attention``), at every impl, as
  the reference does.
* Decode is absorbed: ``W_uk`` folds into the query, so scores form
  against the latent cache directly.  On ``xla`` a masked softmax; on
  ``bitstopper_xla`` the block BitStopper oracle
  (``core/block_adaptation.py``) over K rows ``[c_kv ; k_pe]`` of width
  kv_rank + rope_dim, with the query rescaled so that the oracle's
  ``1/sqrt(d)`` gives the model's ``1/sqrt(qk_dim)``.

The cache is a contiguous shared-cursor layout; the write lands in place
at ``length``, its start clamped as ``dynamic_update_slice`` clamps it.

Under training's rules (``sharding/rules.py:make_rules``) whose "model"
dim splits the heads of ``wq_b`` and ``wkv_b``, the cache-free forward
runs Megatron's split (:func:`_train_split`): the latents ``q_lat``,
``c_kv`` and the shared RoPE key enter the region
(``sharding/api.py:enter_model``, so their gradients are summed over
"model"), each rank expands and attends its own heads, and ``wo``'s rows
are summed over "model" (``leave_model``).  Where "model" does not divide
the heads the layer runs whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.besf import BitStopperConfig
from repro_torch.core.lats import NEG_INF
from repro_torch.models import layers as L
from repro_torch.sharding.api import (enter_model, leave_model, model_split,
                                      training_rules)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_rank: int = 1536
    kv_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    impl: str = "xla"               # decode path: "xla" | "bitstopper_xla"
    bitstopper: BitStopperConfig = BitStopperConfig()
    chunk_q: int = 512
    chunk_k: int = 512


def init_mla(generator, cfg: MLAConfig, device=None, dtype=torch.float32):
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq_a": L.init_linear(generator, cfg.d_model, cfg.q_rank, False,
                              device, dtype),
        "q_norm": L.init_rmsnorm(cfg.q_rank, device, dtype),
        "wq_b": L.init_linear(generator, cfg.q_rank, (cfg.n_heads, qk_dim),
                              False, device, dtype),
        "wkv_a": L.init_linear(generator, cfg.d_model,
                               cfg.kv_rank + cfg.qk_rope_dim, False, device,
                               dtype),
        "kv_norm": L.init_rmsnorm(cfg.kv_rank, device, dtype),
        "wkv_b": L.init_linear(generator, cfg.kv_rank,
                               (cfg.n_heads,
                                cfg.qk_nope_dim + cfg.v_head_dim),
                               False, device, dtype),
        "wo": L.init_linear(generator, cfg.n_heads * cfg.v_head_dim,
                            cfg.d_model, False, device, dtype),
    }


def _keep(t):
    return t


def _project_q(p, x, cfg: MLAConfig, positions, enter=_keep):
    q_lat = enter(L.rms_norm(p["q_norm"], L.linear(p["wq_a"], x)))
    q = L.linear(p["wq_b"], q_lat)                     # [B,S,H,nope+rope]
    q_pe = L.rope(q[..., cfg.qk_nope_dim:], positions[None, :],
                  cfg.rope_theta)
    return q[..., :cfg.qk_nope_dim], q_pe


def _project_kv_latent(p, x, cfg: MLAConfig, positions, enter=_keep):
    kv = L.linear(p["wkv_a"], x)                       # [B,S,rank+rope]
    c_kv = L.rms_norm(p["kv_norm"], kv[..., :cfg.kv_rank])
    k_pe = L.rope(kv[..., None, cfg.kv_rank:], positions[None, :],
                  cfg.rope_theta)[..., 0, :]
    return enter(c_kv), enter(k_pe)


def _train_split(cfg: MLAConfig, cache):
    """``(rules, local cfg)`` where training's rules split this layer's
    heads over "model" (``sharding/api.py:model_split`` of ``wq_b``), else
    None; the local cfg counts the rank's heads."""
    rules = training_rules()
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    if rules is None or not model_split(rules, "mla/wq_b/w",
                                        (cfg.q_rank, cfg.n_heads, qk), 1):
        return None
    if cache is not None:
        raise ValueError("training's rules split the MLA heads of a "
                         "cache-free forward only")
    return rules, dataclasses.replace(
        cfg, n_heads=cfg.n_heads // rules.shape["model"])


def _f32(a):
    return a if a.dtype == torch.float32 else a.float()


def _latent_scores_bitstopper(q_abs, q_pe, c_all, pe_all, mask,
                              cfg: MLAConfig):
    """Block BESF logits [B, H, S, T] of the absorbed queries against the
    latent K rows, NEG_INF where pruned or masked."""
    from repro_torch.core.block_adaptation import block_bitstopper_attention
    q_cat = torch.cat([q_abs, q_pe.float()], -1)
    k_cat = torch.cat([c_all, pe_all], -1).float()     # [B,T,rank+rope]
    qt = q_cat.transpose(1, 2)                         # [B,H,S,d]
    B, H, S, d_lat = qt.shape
    T = k_cat.shape[1]
    sm = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    qt = qt * (sm * d_lat ** 0.5)
    kb = k_cat[:, None].expand(B, H, T, d_lat)
    vb = torch.ones((B, H, T, 1), dtype=torch.float32, device=qt.device)
    return block_bitstopper_attention(
        qt, kb, vb, cfg=cfg.bitstopper, block_q=min(128, S),
        block_k=min(128, T), mask=mask).scores


def mla_attention(p, x: torch.Tensor, positions: torch.Tensor,
                  cfg: MLAConfig, cache: dict[str, Any] | None = None):
    """x [B, S, d_model], positions [S] -> (out, new_cache)."""
    from repro_torch.models.attention import chunked_attention
    B, S, _ = x.shape
    tp = _train_split(cfg, cache)
    enter = _keep
    if tp is not None:
        rules, cfg = tp

        def enter(t):
            return enter_model(t, rules)
    q_nope, q_pe = _project_q(p, x, cfg, positions, enter)
    c_kv, k_pe = _project_kv_latent(p, x, cfg, positions, enter)

    if cache is None:
        kv = L.linear(p["wkv_b"], c_kv)                # [B,S,H,nope+v]
        k_nope, v = kv[..., :cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim:]
        k_pe_h = k_pe[:, :, None, :].expand(B, S, cfg.n_heads,
                                            cfg.qk_rope_dim)
        q_full = torch.cat([q_nope, q_pe], -1)
        k_full = torch.cat([k_nope, k_pe_h], -1)
        out = chunked_attention(q_full, k_full, v, positions, positions,
                                causal=True, window=None,
                                chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)
        out = out.reshape(B, S, cfg.n_heads * cfg.v_head_dim)
        return leave_model(L.linear(p["wo"], out), training_rules(),
                           partial=tp is not None), None

    T = cache["c_kv"].shape[1]
    start = min(max(int(cache["length"]), 0), T - S)
    cache["c_kv"][:, start:start + S] = c_kv.to(cache["c_kv"].dtype)
    cache["k_pe"][:, start:start + S] = k_pe.to(cache["k_pe"].dtype)
    c_all, pe_all = cache["c_kv"], cache["k_pe"]
    new_cache = dict(cache, length=cache["length"] + S)

    w_kv_b = p["wkv_b"]["w"]                           # [rank, H, nope+v]
    w_uk = w_kv_b[..., :cfg.qk_nope_dim]
    w_uv = w_kv_b[..., cfg.qk_nope_dim:]
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk.float())
    mask = (torch.arange(T, device=x.device)[None, :]
            <= positions.to(x.device)[:, None])         # [S, T]

    if cfg.impl == "bitstopper_xla":
        logits = _latent_scores_bitstopper(q_abs, q_pe, c_all, pe_all, mask,
                                           cfg)
        pruned = logits <= NEG_INF / 2
        probs = torch.softmax(torch.where(pruned,
                                          torch.full_like(logits, NEG_INF),
                                          logits), dim=-1)
        probs = torch.where(pruned, torch.zeros_like(probs), probs)
    else:
        sm = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
        s_lat = torch.einsum("bshr,btr->bhst",
                             _f32(q_abs.to(c_all.dtype)), _f32(c_all))
        s_pe = torch.einsum("bshr,btr->bhst",
                            _f32(q_pe.to(pe_all.dtype)), _f32(pe_all))
        logits = (s_lat + s_pe) * sm
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, NEG_INF))
        probs = torch.softmax(logits, dim=-1)

    ctx_lat = torch.einsum("bhst,btr->bshr", _f32(probs.to(c_all.dtype)),
                           _f32(c_all))
    out = torch.einsum("bshr,rhv->bshv", ctx_lat, w_uv.float())
    out = out.reshape(B, S, cfg.n_heads * cfg.v_head_dim).to(x.dtype)
    return L.linear(p["wo"], out), new_cache


def init_mla_cache(cfg: MLAConfig, batch: int, max_len: int,
                   dtype=torch.float32, device=None):
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_rank), dtype=dtype,
                            device=device),
        "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                            device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }

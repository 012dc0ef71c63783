"""The transformer stack: embedding -> block segments -> head.

Counterpart of ``repro/models/transformer.py``: every block kind of the
registry (``attn``, ``local_attn``, ``mla``, ``ssm`` and ``rglru`` mixers;
dense, ``moe`` or no FFN), the MTP head and ``forward(..., embeds=)``.
The reference scans stacked segment parameters (``seg0`` leaves carry a
leading ``[reps]`` axis); the port keeps one parameter dict and one cache
dict per layer (``params["seg0"]`` is a list of units) and loops over
them.  Under mesh rules (``sharding/``; ``PagedEngine`` with a mesh)
every dense layer runs replicated on each rank at the full slot count, and
the attention layers run their paged block per rank
(``models/attention.py``).  :func:`params_from_numpy`,
:func:`caches_from_numpy`, :func:`caches_to_numpy` and
:func:`params_to_numpy` convert between the two layouts, so tests can carry
weights across both ways and compare cache trees, and checkpoints are
written in the reference's layout.

Training remats as the reference does: ``cfg.remat`` wraps each unit of a
segment the reference scans (``scan_layers`` and reps > 1) in
``torch.utils.checkpoint`` (:func:`_remat_wrap`): "none", "full" (keep
only the unit's input, recompute the rest in backward) or "dots" (keep the
matmul outputs, recompute the rest).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.attention import (PagedLayout, attention,
                                          init_attention, init_cache)
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.mla import init_mla, init_mla_cache, mla_attention
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.rglru import (init_rglru, init_rglru_cache,
                                      rglru_forward)
from repro_torch.models.ssm import init_ssm, init_ssm_cache, ssm_forward
from repro_torch.sharding.api import current_rules

_ATTN = ("attn", "local_attn")


def init_block(generator, spec: BlockSpec, cfg: ModelConfig, device=None):
    dt = cfg.parameter_dtype
    p: dict[str, Any] = {"norm1": L.init_norm(cfg.d_model, cfg.norm, device,
                                              dt)}
    if spec.mixer in _ATTN:
        p["attn"] = init_attention(
            generator, cfg.attn_config(spec.mixer == "local_attn"), device,
            dt)
    elif spec.mixer == "mla":
        p["mla"] = init_mla(generator, cfg.mla_config(), device, dt)
    elif spec.mixer == "ssm":
        p["ssm"] = init_ssm(generator, cfg.ssm_config(), device, dt)
    elif spec.mixer == "rglru":
        p["rglru"] = init_rglru(generator, cfg.rglru_config(), device, dt)
    else:
        raise ValueError(spec.mixer)
    if spec.ffn != "none":
        p["norm2"] = L.init_norm(cfg.d_model, cfg.norm, device, dt)
        if spec.ffn == "moe":
            p["moe"] = init_moe(generator, cfg.moe_config(), device, dt)
        else:
            p["ffn"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                                  False, device, dt)
    return p


def block_forward(p, x, positions, spec: BlockSpec, cfg: ModelConfig,
                  cache=None):
    """Returns (x, new_cache, aux_loss); aux_loss is None without a MoE
    FFN (no launch a layer for a zero).  A speculative verify runs the
    per-token layers position by position (``layers.by_column``); the
    routed experts of a MoE FFN see the whole call, as in the reference."""
    split = cfg.spec_verify and cache is not None
    h = L.by_column(lambda t: L.norm(p["norm1"], t), x, split)
    if spec.mixer in _ATTN:
        out, new_cache = attention(
            p["attn"], h, positions,
            cfg.attn_config(spec.mixer == "local_attn"), cache)
    elif spec.mixer == "mla":
        out, new_cache = mla_attention(p["mla"], h, positions,
                                       cfg.mla_config(), cache)
    elif spec.mixer == "ssm":
        out, new_cache = ssm_forward(p["ssm"], h, cfg.ssm_config(), cache)
    elif spec.mixer == "rglru":
        out, new_cache = rglru_forward(p["rglru"], h, cfg.rglru_config(),
                                       cache)
    else:
        raise ValueError(spec.mixer)
    x = x + out
    aux = None
    if spec.ffn == "moe":
        h2 = L.by_column(lambda t: L.norm(p["norm2"], t), x, split)
        rules = current_rules()
        y, aux = moe_ffn(p["moe"], h2, cfg.moe_config(),
                         mesh=rules.mesh if rules is not None else None,
                         split=split)
        x = x + y
    elif spec.ffn != "none":
        x = x + L.by_column(
            lambda t: L.mlp(p["ffn"], L.norm(p["norm2"], t), cfg.act), x,
            split)
    return x.to(cfg.activation_dtype), new_cache, aux


def init_model(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Seeded parameters with the reference's shapes and init
    distributions (not its values: the two frameworks draw different
    numbers from one seed)."""
    dt = cfg.parameter_dtype
    params: dict[str, Any] = {
        "embed": L.init_embedding(generator, cfg.vocab, cfg.d_model, device,
                                  dt),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, device, dt),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_linear(generator, cfg.d_model, cfg.vocab,
                                          False, device, dt)
    for si, (unit, reps) in enumerate(cfg.segments):
        params[f"seg{si}"] = [
            {f"b{i}": init_block(generator, spec, cfg, device)
             for i, spec in enumerate(unit)}
            for _ in range(reps)]
    if cfg.mtp:
        params["mtp_block"] = init_block(generator, cfg.segments[-1][0][-1],
                                         cfg, device)
        params["mtp_proj"] = L.init_linear(generator, 2 * cfg.d_model,
                                           cfg.d_model, False, device, dt)
        params["mtp_norm"] = L.init_norm(cfg.d_model, cfg.norm, device, dt)
    return params


_DOTS = ("mm", "bmm", "addmm")


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matrix products, recompute
    everything else.  Products run without autograd (inside the chunked
    attention's own forward, whose backward recomputes its tiles) are not
    kept, so that attention stays O(S x D)."""
    from torch.utils.checkpoint import CheckpointPolicy
    name = getattr(op, "__name__", "").split(".")[0]
    if name in _DOTS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, policy: str):
    """``fn`` under the reference's remat ``policy``: "none", "full" or
    "dots" (non-reentrant ``torch.utils.checkpoint``)."""
    if policy == "none":
        return fn
    from torch.utils import checkpoint as ckpt
    if policy == "dots":
        def context():
            return ckpt.create_selective_checkpoint_contexts(_save_dots)
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                          context_fn=context)
    if policy == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    raise ValueError(f"unknown remat policy {policy!r}")


def run_segments(params, x, positions, cfg: ModelConfig, caches=None):
    """``caches``: None or {segN: [per-rep {bI: layer cache}]}.  Returns
    (x, new_caches, summed aux loss).  Without caches and where a gradient
    is needed, each unit of a scanned segment runs under ``cfg.remat``."""
    new_caches: dict[str, Any] = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (unit, reps) in enumerate(cfg.segments):
        seg_c = caches.get(f"seg{si}") if caches is not None else None

        def unit_fwd(x, p_unit, c_unit, unit=unit):
            aux = None
            ncs = {}
            for i, spec in enumerate(unit):
                c = c_unit[f"b{i}"] if c_unit is not None else None
                x, nc, a = block_forward(p_unit[f"b{i}"], x, positions,
                                         spec, cfg, c)
                if a is not None:
                    aux = a if aux is None else aux + a
                if nc is not None:
                    ncs[f"b{i}"] = nc
            return x, (ncs or None), aux

        remat = (cfg.remat != "none" and cfg.scan_layers and reps > 1
                 and seg_c is None and L.needs_grad(x))
        if remat:
            def unit_remat(x, p_unit, unit_fwd=unit_fwd):
                y, _, aux = unit_fwd(x, p_unit, None)
                return y, (aux if aux is not None else torch.zeros(
                    (), dtype=torch.float32, device=x.device))
            body = _remat_wrap(unit_remat, cfg.remat)
        seg_new = []
        for li in range(reps):
            p_unit = params[f"seg{si}"][li]
            if remat:
                x, aux = body(x, p_unit)
                ncs = None
            else:
                x, ncs, aux = unit_fwd(x, p_unit,
                                       seg_c[li] if seg_c is not None
                                       else None)
            if aux is not None:
                aux_total = aux_total + aux
            seg_new.append(ncs)
        if any(c is not None for c in seg_new):
            new_caches[f"seg{si}"] = seg_new
    return x, (new_caches or None), aux_total


def forward(params, tokens: torch.Tensor | None, cfg: ModelConfig,
            caches=None, positions: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None):
    """tokens [B, S] (or ``embeds`` [B, S, D] from a stubbed frontend) ->
    (logits [B, S, vocab] f32, new_caches, aux_loss)."""
    if embeds is None:
        x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    else:
        x = embeds.to(cfg.activation_dtype)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x, new_caches, aux = run_segments(params, x, positions, cfg, caches)

    def head(t):
        h = L.norm(params["final_norm"], t)
        if cfg.tie_embeddings:
            return L.unembed(params["embed"], h)
        return L.linear(params["unembed"], h).float()

    logits = L.by_column(head, x, cfg.spec_verify and caches is not None)
    return logits, new_caches, aux


def mtp_logits(params, tokens, h, cfg: ModelConfig, positions):
    """DeepSeek-style MTP: predict token t+2 from [h_t ; emb(token_{t+1})]."""
    emb_next = L.embed(params["embed"], torch.roll(tokens, -1, 1))
    cat = torch.cat([L.norm(params["mtp_norm"], h), emb_next.to(h.dtype)],
                    -1)
    x = L.linear(params["mtp_proj"], cat)
    x, _, _ = block_forward(params["mtp_block"], x, positions,
                            cfg.segments[-1][0][-1], cfg)
    return L.unembed(params["embed"], L.norm(params["final_norm"], x))


def init_block_cache(spec: BlockSpec, cfg: ModelConfig, batch: int,
                     max_len: int | None, dtype=torch.float32,
                     per_slot: bool = False,
                     paged: PagedLayout | None = None, device=None):
    """One layer's cache: ``local_attn`` layers get a ring of
    ``min(max_len, window)`` slots in a contiguous layout; the per-slot and
    paged layouts take attention mixers only, as in the reference."""
    if spec.mixer in _ATTN:
        local = spec.mixer == "local_attn"
        return init_cache(cfg.attn_config(local), batch, max_len, dtype,
                          ring=local, per_slot=per_slot, paged=paged,
                          device=device)
    if per_slot or paged is not None:
        raise NotImplementedError(
            f"per-slot/paged serving caches support attn/local_attn mixers "
            f"only, got {spec.mixer!r}")
    if spec.mixer == "mla":
        return init_mla_cache(cfg.mla_config(), batch, max_len, dtype,
                              device)
    if spec.mixer == "ssm":
        return init_ssm_cache(cfg.ssm_config(), batch, dtype, device)
    if spec.mixer == "rglru":
        return init_rglru_cache(cfg.rglru_config(), batch, dtype, device)
    raise ValueError(spec.mixer)


def init_caches(cfg: ModelConfig, batch: int, max_len: int | None = None,
                dtype=torch.float32, per_slot: bool = False,
                paged: PagedLayout | None = None, device=None):
    """Per-layer caches {segN: [per-rep {bI: layer cache}]}: contiguous
    (shared cursor, or ``per_slot`` for continuous batching) or, with
    ``paged``, block pools addressed through per-slot tables."""
    caches: dict[str, Any] = {}
    for si, (unit, reps) in enumerate(cfg.segments):
        caches[f"seg{si}"] = [
            {f"b{i}": init_block_cache(spec, cfg, batch, max_len, dtype,
                                       per_slot, paged, device)
             for i, spec in enumerate(unit)}
            for _ in range(reps)]
    return caches


# ---------------------------------------------------------------------------
# Bridge to the reference's pytrees (numpy arrays in, numpy arrays out)
# ---------------------------------------------------------------------------


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _unstack(tree, reps: int) -> list:
    """A stacked segment tree (leaves [reps, ...]) -> one tree per rep."""
    return [_map_tree(lambda a, i=i: a[i], tree) for i in range(reps)]


def _segments_from_numpy(tree, cfg: ModelConfig, device):
    out = {}
    for key, val in tree.items():
        if key.startswith("seg"):
            reps = cfg.segments[int(key[3:])][1]
            units = val if isinstance(val, list) else _unstack(val, reps)
            val = units
        out[key] = _map_tree(lambda a: A.tensor_from_host(a, device), val)
    return out


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The reference's parameter pytree (numpy leaves) -> the port's
    parameters; scanned segments (stacked expert leaves [reps, E, ...]
    too) are un-stacked into per-layer dicts; the MTP leaves carry over
    as they are."""
    return _segments_from_numpy(tree, cfg, device)


def caches_from_numpy(tree, cfg: ModelConfig, device=None):
    """The reference's cache pytree (numpy leaves; paged or contiguous,
    a shared cursor's ``length`` a 0-d leaf; bf16 leaves as ml_dtypes
    arrays or their bits) -> per-layer caches."""
    return _segments_from_numpy(tree, cfg, device)


def params_to_numpy(params, cfg: ModelConfig):
    """The port's parameters -> the reference's parameter pytree (numpy
    leaves; segments it scans stacked along a leading axis)."""
    return caches_to_numpy(params, cfg)


def caches_to_numpy(caches, cfg: ModelConfig):
    """Per-layer caches -> the reference's layout: segments the reference
    scans (``scan_layers`` and reps > 1) are stacked along a leading axis;
    bf16 leaves as their bits (uint16)."""
    out = {}
    for key, units in caches.items():
        units = _map_tree(lambda t: A.host_array(t.detach()), units)
        if not key.startswith("seg"):
            out[key] = units
            continue
        reps = cfg.segments[int(key[3:])][1]
        if cfg.scan_layers and reps > 1:
            out[key] = _map_tree_n(lambda *xs: np.stack(xs), units)
        else:
            out[key] = units
    return out


def _map_tree_n(fn, trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_tree_n(fn, [t[k] for t in trees]) for k in first}
    return fn(*trees)

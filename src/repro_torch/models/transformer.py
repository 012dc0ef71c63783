"""The transformer stack: embedding -> block segments -> head.

Counterpart of ``repro/models/transformer.py`` for the ``attn`` /
``local_attn`` mixers with a dense FFN.  The reference scans stacked
segment parameters (``seg0`` leaves carry a leading ``[reps]`` axis); the
port keeps one parameter dict and one cache dict per layer
(``params["seg0"]`` is a list of units) and loops over them.
:func:`params_from_numpy`, :func:`caches_from_numpy` and
:func:`caches_to_numpy` convert between the two layouts, so tests can carry
the reference's weights across and compare cache trees.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.attention import (PagedLayout, attention,
                                          init_attention, init_cache)
from repro_torch.models.config import BlockSpec, ModelConfig

_MIXERS = ("attn", "local_attn")


def _check_mixer(spec: BlockSpec) -> None:
    if spec.mixer not in _MIXERS or spec.ffn not in ("dense", "none"):
        raise NotImplementedError(
            f"block {spec} is not ported yet: this slice builds attn/"
            f"local_attn mixers with a dense FFN (ROADMAP A10)")


def init_block(generator, spec: BlockSpec, cfg: ModelConfig, device=None):
    _check_mixer(spec)
    dt = cfg.parameter_dtype
    p: dict[str, Any] = {
        "norm1": L.init_norm(cfg.d_model, cfg.norm, device, dt),
        "attn": init_attention(
            generator, cfg.attn_config(spec.mixer == "local_attn"), device,
            dt),
    }
    if spec.ffn != "none":
        p["norm2"] = L.init_norm(cfg.d_model, cfg.norm, device, dt)
        p["ffn"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                              False, device, dt)
    return p


def block_forward(p, x, positions, spec: BlockSpec, cfg: ModelConfig,
                  cache=None):
    """Returns (x, new_cache).  A speculative verify runs the per-token
    layers position by position (``layers.by_column``)."""
    split = cfg.spec_verify and cache is not None
    h = L.by_column(lambda t: L.norm(p["norm1"], t), x, split)
    out, new_cache = attention(
        p["attn"], h, positions, cfg.attn_config(spec.mixer == "local_attn"),
        cache)
    x = x + out
    if spec.ffn != "none":
        x = x + L.by_column(
            lambda t: L.mlp(p["ffn"], L.norm(p["norm2"], t), cfg.act), x,
            split)
    return x.to(cfg.activation_dtype), new_cache


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
    return params


def run_segments(params, x, positions, cfg: ModelConfig, caches=None):
    """``caches``: None or {segN: [per-rep {bI: layer cache}]}."""
    new_caches: dict[str, Any] = {}
    for si, (unit, reps) in enumerate(cfg.segments):
        seg_c = caches.get(f"seg{si}") if caches is not None else None
        seg_new = []
        for li in range(reps):
            ncs = {}
            for i, spec in enumerate(unit):
                c = seg_c[li][f"b{i}"] if seg_c is not None else None
                x, nc = block_forward(params[f"seg{si}"][li][f"b{i}"], x,
                                      positions, spec, cfg, c)
                if nc is not None:
                    ncs[f"b{i}"] = nc
            seg_new.append(ncs or None)
        if any(c is not None for c in seg_new):
            new_caches[f"seg{si}"] = seg_new
    return x, (new_caches or None)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, caches=None,
            positions: torch.Tensor | None = None):
    """tokens [B, S] -> (logits [B, S, vocab] f32, new_caches, aux_loss)."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x, new_caches = run_segments(params, x, positions, cfg, caches)

    def head(t):
        h = L.norm(params["final_norm"], t)
        if cfg.tie_embeddings:
            return L.unembed(params["embed"], h)
        return L.linear(params["unembed"], h).float()

    logits = L.by_column(head, x, cfg.spec_verify and caches is not None)
    return logits, new_caches, torch.zeros((), device=logits.device)


def init_block_cache(spec: BlockSpec, cfg: ModelConfig, batch: int,
                     max_len: int | None, dtype=torch.float32,
                     per_slot: bool = False,
                     paged: PagedLayout | None = None, device=None):
    """One layer's cache: ``local_attn`` layers get a ring of
    ``min(max_len, window)`` slots in a contiguous layout."""
    if spec.mixer in _MIXERS:
        local = spec.mixer == "local_attn"
        return init_cache(cfg.attn_config(local), batch, max_len, dtype,
                          ring=local, per_slot=per_slot, paged=paged,
                          device=device)
    if per_slot or paged is not None:
        raise NotImplementedError(
            f"per-slot/paged serving caches support attn/local_attn mixers "
            f"only, got {spec.mixer!r}")
    raise NotImplementedError(f"the {spec.mixer!r} mixer's cache is not "
                              f"ported yet (ROADMAP A10, the model zoo)")


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
        out[key] = _map_tree(
            lambda a: torch.as_tensor(np.array(a), device=device), val)
    return out


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The reference's parameter pytree (numpy leaves) -> the port's
    parameters; scanned segments are un-stacked into per-layer dicts."""
    return _segments_from_numpy(tree, cfg, device)


def caches_from_numpy(tree, cfg: ModelConfig, device=None):
    """The reference's cache pytree (numpy leaves; paged or contiguous,
    a shared cursor's ``length`` a 0-d leaf) -> per-layer caches."""
    return _segments_from_numpy(tree, cfg, device)


def caches_to_numpy(caches, cfg: ModelConfig):
    """Per-layer caches -> the reference's layout: segments the reference
    scans (``scan_layers`` and reps > 1) are stacked along a leading axis."""
    out = {}
    for key, units in caches.items():
        reps = cfg.segments[int(key[3:])][1]
        units = _map_tree(lambda t: t.detach().cpu().numpy(), units)
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

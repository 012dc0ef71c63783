"""The train step: loss, grads, microbatching, int8 gradient compression.

Counterpart of ``repro/train/train_step.py``:

* **loss**: next-token cross-entropy (+ the MoE aux loss, + MTP at t+2),
  through a sequence-chunked LM head that never holds a [B, S, vocab]
  tensor (:func:`chunked_lm_loss`);
* **grad accumulation**: ``microbatches > 1`` runs the batch in slices and
  sums their gradients in f32;
* **int8 gradient compression with error feedback** (:func:`compress_grads`):
  per-leaf symmetric int8 with the residual carried to the next step.  The
  reference applies it only inside its data-parallel all-reduce, under mesh
  rules; on one device the step carries ``err`` unchanged, as there.  The
  all-reduce itself (:func:`allreduce_int8_ef`) belongs to mesh training.

The state is ``{"params", "opt", ["err"]}`` over the port's per-layer
parameter tree; :func:`state_to_numpy` / :func:`state_from_numpy` convert it
to and from the reference's layout (scanned segments stacked), the layout
checkpoints are written in.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.attention import tensor_from_host
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         cosine_schedule, init_opt_state,
                                         tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1
    mtp_weight: float = 0.3
    grad_compression: str = "none"     # none | int8_ef


def lm_loss(logits, tokens, ignore_last: bool = True):
    """Next-token NLL.  logits [B, S, V] f32, tokens [B, S]."""
    tgt = torch.roll(tokens, -1, 1).long()
    ll = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(ll, -1, tgt[..., None])[..., 0]
    if ignore_last:
        w = torch.ones_like(nll)
        w[:, -1] = 0.0
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
    return nll.mean()


def _chunk_nll(hx, w_dv, tx, wx):
    """One chunk of the LM head and its NLL: (sum of weighted NLL, sum of
    weights).  The target logit is taken with a one-hot product, as the
    reference takes it."""
    logits = hx.float() @ w_dv.float()                     # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)
    onehot = (tx[..., None] == torch.arange(
        logits.shape[-1], device=tx.device)).to(logits.dtype)
    tgt_logit = torch.einsum("bcv,bcv->bc", logits, onehot)
    nll = (lse - tgt_logit) * wx
    return nll.sum(), wx.sum()


def chunked_lm_loss(h, params, targets, cfg: ModelConfig, chunk: int = 512,
                    shift: int = 1):
    """Sequence-chunked LM head and NLL: never a [B, S, vocab] tensor.

    Each chunk computes one [B, chunk, V] slice of logits and reduces it at
    once; where a gradient is needed, the chunk is recomputed in backward (the
    reference's ``jax.checkpoint``), so at most one slice is alive."""
    B, S, _ = h.shape
    c = min(chunk, S)
    pad = (-S) % c
    tgt = torch.roll(targets, -shift, 1)
    w = torch.ones((B, S), dtype=torch.float32, device=h.device)
    w[:, S - shift:] = 0.0
    if pad:
        F = torch.nn.functional
        h = F.pad(h, (0, 0, 0, pad))
        tgt = F.pad(tgt, (0, pad))
        w = F.pad(w, (0, pad))
    w_dv = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["unembed"]["w"])
    step = _chunk_nll
    if L.needs_grad(h, w_dv):
        from torch.utils.checkpoint import checkpoint

        def step(*a):
            return checkpoint(_chunk_nll, *a, use_reentrant=False)
    total, count = 0.0, 0.0
    for c0 in range(0, h.shape[1], c):
        nll, wsum = step(h[:, c0:c0 + c], w_dv, tgt[:, c0:c0 + c],
                         w[:, c0:c0 + c])
        total, count = total + nll, count + wsum
    return total / torch.clamp(count, min=1.0)


def loss_fn(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """batch: tokens [B, S] int, or {"tokens": ..., "patches": [B, P, D]}
    for the stubbed-frontend VLM archs (loss over the text positions)."""
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    patches = batch.get("patches") if isinstance(batch, dict) else None
    n_patch = 0
    if patches is not None:
        n_patch = patches.shape[1]
        text = L.embed(params["embed"], tokens)
        x = torch.cat([patches.to(text.dtype), text], 1).to(
            cfg.activation_dtype)
    else:
        x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    h, _, aux = T.run_segments(params, x, positions, cfg)
    if n_patch:
        h = h[:, n_patch:]                 # loss over the text positions
        positions = positions[: h.shape[1]]
    hn = L.norm(params["final_norm"], h)
    loss = chunked_lm_loss(hn, params, tokens, cfg) + aux
    if cfg.mtp:
        # MTP shares the trunk: one extra block over [h_t ; emb(t+1)]
        # predicting token t+2 (the chunked head again).
        emb_next = L.embed(params["embed"], torch.roll(tokens, -1, 1))
        cat = torch.cat([L.norm(params["mtp_norm"], h),
                         emb_next.to(h.dtype)], -1)
        xm = L.linear(params["mtp_proj"], cat)
        xm, _, _ = T.block_forward(params["mtp_block"], xm, positions,
                                   cfg.segments[-1][0][-1], cfg)
        hm = L.norm(params["final_norm"], xm)
        loss = loss + tcfg.mtp_weight * chunked_lm_loss(
            hm, params, tokens, cfg, shift=2)
    return loss


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------


def _compress_int8(g, err):
    gf = g.float() + err
    scale = torch.clamp(gf.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq            # residual -> error feedback


def compress_grads(grads, err_state):
    """Returns (int8 tree, scale tree, new error state)."""
    qs = tree_map(_compress_int8, grads, err_state)
    q, s, e = (tree_map(lambda t, i=i: t[i], qs) for i in range(3))
    return q, s, e


def decompress_grads(q, s):
    return tree_map(lambda qi, si: qi.float() * si, q, s)


def allreduce_int8_ef(grads, err_state, mesh, data_axes=("data",)):
    """The int8 all-reduce over the data axes with error feedback: part of
    mesh training, which the port does not have yet."""
    raise NotImplementedError(
        "allreduce_int8_ef runs under mesh training rules: mesh training "
        "is the next slice of the port (ROADMAP A10)")


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def value_and_grad(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """(loss, grads) of :func:`loss_fn`; grads mirror ``params`` (zeros
    for a leaf the loss does not reach)."""
    leaves = tree_leaves(params)
    loss = loss_fn(params, batch, cfg, tcfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns step(state, tokens) -> (state, metrics).  The update writes
    the state's parameters and moments in place (``adamw_update``)."""

    def grads_of(params, tokens):
        if tcfg.microbatches <= 1:
            return value_and_grad(params, tokens, cfg, tcfg)
        n = tcfg.microbatches

        def slice_mb(x, i):
            mb = x.shape[0] // n
            return x[i * mb:(i + 1) * mb]

        loss_acc = 0.0
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(n):
            batch = (tree_map(lambda x: slice_mb(x, i), tokens)
                     if isinstance(tokens, dict) else slice_mb(tokens, i))
            loss, g = value_and_grad(params, batch, cfg, tcfg)
            g_acc = tree_map(torch.add, g_acc, g)
            loss_acc = loss_acc + loss
        inv = 1.0 / n
        return loss_acc * inv, tree_map(lambda g: g * inv, g_acc)

    def step(state, tokens):
        from repro_torch.sharding.api import current_rules
        params, opt, err = state["params"], state["opt"], state.get("err")
        loss, grads = grads_of(params, tokens)
        if tcfg.grad_compression == "int8_ef" and err is not None:
            rules = current_rules()
            if rules is not None:
                grads, err = allreduce_int8_ef(grads, err, rules.mesh)
        lr_scale = cosine_schedule(opt["step"], warmup=tcfg.warmup_steps,
                                   total=tcfg.total_steps)
        params, opt, metrics = adamw_update(params, grads, opt,
                                            tcfg.optimizer, lr_scale)
        new_state = dict(state, params=params, opt=opt)
        if err is not None:
            new_state["err"] = err
        return new_state, dict(metrics, loss=loss)

    return step


def trainable(params):
    """``params`` with every leaf set to require gradients (in place)."""
    return tree_map(lambda p: p.requires_grad_(True), params)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: torch.Generator, device=None):
    """Seeded parameters (``transformer.init_model``), zero moments and, with
    ``grad_compression="int8_ef"``, a zero error-feedback tree."""
    params = trainable(T.init_model(cfg, generator, device))
    state: dict[str, Any] = {
        "params": params,
        "opt": init_opt_state(params, tcfg.optimizer),
    }
    if tcfg.grad_compression == "int8_ef":
        state["err"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


# ---------------------------------------------------------------------------
# The reference's layout (checkpoints)
# ---------------------------------------------------------------------------

_LAYERED = ("params", "err")


def state_to_numpy(state, cfg: ModelConfig):
    """The train state as the reference's pytree of numpy arrays: the
    parameter-shaped trees (params, moments, err) with scanned segments
    stacked, ``opt/step`` a 0-d int32 array."""
    out = {k: T.params_to_numpy(state[k], cfg) for k in _LAYERED
           if k in state}
    opt = state["opt"]
    out["opt"] = {"m": T.params_to_numpy(opt["m"], cfg),
                  "v": T.params_to_numpy(opt["v"], cfg),
                  "step": np.asarray(opt["step"].cpu().numpy(), np.int32)}
    return out


def state_from_numpy(tree, cfg: ModelConfig, device=None):
    """The inverse of :func:`state_to_numpy`: per-layer tensors on
    ``device``, parameters set to require gradients."""
    state = {k: T.params_from_numpy(tree[k], cfg, device) for k in _LAYERED
             if k in tree}
    state["params"] = trainable(state["params"])
    opt = tree["opt"]
    state["opt"] = {"m": T.params_from_numpy(opt["m"], cfg, device),
                    "v": T.params_from_numpy(opt["v"], cfg, device),
                    "step": tensor_from_host(np.asarray(opt["step"],
                                                        np.int32), device)}
    return state

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
  rules (:func:`allreduce_int8_ef`); on one device the step carries
  ``err`` unchanged, as there.

**Mesh training.**  Under training's rules (``sharding/rules.py:
make_rules``, made active with ``sharding/api.py:use_rules``) the state
is this rank's blocks (``sharding/api.py:shard_state``) and the step takes
this rank's rows of the batch (its "data" block, ``SyntheticLMDataset``'s
shard).  The loss gathers the weights' "data" blocks
(``transformer.gather_weights``), runs the layers' Megatron split, takes
the LM head vocab-parallel (:func:`chunked_lm_loss`) and divides by the
global token count; each gradient comes back summed over the batch and cut
to the rank's block (the reference's gradient pin), and the clip and the
``grad_norm`` metric take the global norm (``optimizer.global_norm``).
Every block kind trains: attention and MLA split their heads, dense FFNs
their hidden units, MoE FFNs their experts (``models/moe.py``'s EP,
expert-TP and resident training branches, at one device's drops and aux
loss), and SSM and RG-LRU blocks, whose "model" blocks cut across their
channels' parts, read their weights whole (the "model" split is storage
only).  Under ``make_rules(sequence_parallel=True)`` the residual stream
between blocks is this rank's part of the sequence: each block gathers it
at its input and leaves by a reduce-scatter (``sharding/api.py:
leave_model``), and every weight not split over "model" sums its gradient
over "model" too.  With ``microbatches > 1`` the data ranks' rows are
dealt microbatch-major (``data/pipeline.py:shard_rows``), so a mesh
microbatch holds one device's microbatch of its index and drops as one
device does.

The state is ``{"params", "opt", ["err"]}`` over the port's per-layer
parameter tree; :func:`state_to_numpy` / :func:`state_from_numpy` convert it
to and from the reference's layout (scanned segments stacked), the layout
checkpoints are written in.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.attention import tensor_from_host
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.api import (AbstractMesh, batch_sum, block_index,
                                      dim_all_gather, dim_max, dim_sum,
                                      enter_model, gather_shards,
                                      local_shard, mesh_shape, model_split,
                                      reduce_from_model, seq_gather,
                                      seq_parallel, seq_part, seq_rules,
                                      seq_scatter, training_rules, use_rules)
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


def _chunk_nll_vocab_parallel(hx, w_dv, tx, wx, rules, v0):
    """:func:`_chunk_nll` on this rank's vocab block ``[v0, v0 + Vl)``:
    the logsumexp from the max and the sum of exponentials over "model",
    the target logit from the rank that holds it (the others add 0)."""
    logits = hx.float() @ w_dv.float()                     # [B, c, Vl]
    gmax = dim_max(rules.mesh, logits.detach().amax(-1), "model")
    lse = gmax + torch.log(reduce_from_model(
        torch.exp(logits - gmax[..., None]).sum(-1), rules))
    onehot = ((tx - v0)[..., None] == torch.arange(
        logits.shape[-1], device=tx.device)).to(logits.dtype)
    tgt_logit = reduce_from_model(
        torch.einsum("bcv,bcv->bc", logits, onehot), rules)
    nll = (lse - tgt_logit) * wx
    return nll.sum(), wx.sum()


def chunked_lm_loss(h, params, targets, cfg: ModelConfig, chunk: int = 512,
                    shift: int = 1):
    """Sequence-chunked LM head and NLL: never a [B, S, vocab] tensor.

    Each chunk computes one [B, chunk, V] slice of logits and reduces it at
    once; where a gradient is needed, the chunk is recomputed in backward (the
    reference's ``jax.checkpoint``), so at most one slice is alive.  Under
    training's rules the head is vocab-parallel where the rank holds a
    vocab block (:func:`_chunk_nll_vocab_parallel`), and the mean is over
    the global token count (every data rank's).  Under sequence
    parallelism ``h`` is this rank's part of the sequence: gathered for a
    vocab-parallel head, else its part's NLL is summed over "model"."""
    rules = training_rules()
    split = rules is not None and _vocab_split(rules, cfg)
    sp = seq_parallel(rules)
    if sp and split:
        h = seq_gather(h, rules)
    B, S = targets.shape
    tgt = torch.roll(targets, -shift, 1)
    w = torch.ones((B, S), dtype=torch.float32, device=h.device)
    w[:, S - shift:] = 0.0
    if h.shape[1] != S:                    # this rank's part of the sequence
        tgt, w = seq_part(tgt, rules), seq_part(w, rules)
    S = h.shape[1]
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        F = torch.nn.functional
        h = F.pad(h, (0, 0, 0, pad))
        tgt = F.pad(tgt, (0, pad))
        w = F.pad(w, (0, pad))
    w_dv = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["unembed"]["w"])
    fn, extra = _chunk_nll, ()
    if split:
        fn = _chunk_nll_vocab_parallel
        extra = (rules, block_index(rules, "model")[0] * w_dv.shape[1])
        h = enter_model(h, rules)
    step = fn
    if L.needs_grad(h, w_dv):
        from torch.utils.checkpoint import checkpoint

        def step(*a):
            return checkpoint(fn, *a, use_reentrant=False)
    total, count = 0.0, 0.0
    for c0 in range(0, h.shape[1], c):
        nll, wsum = step(h[:, c0:c0 + c], w_dv, tgt[:, c0:c0 + c],
                         w[:, c0:c0 + c], *extra)
        total, count = total + nll, count + wsum
    if rules is not None:
        count = count.detach()
        if sp and not split:
            total = reduce_from_model(total, rules)
            count = dim_sum(rules.mesh, count, "model")
        count = batch_sum(rules, count)
    return total / torch.clamp(count, min=1.0)


def _vocab_split(rules, cfg: ModelConfig) -> bool:
    """Whether training's rules split the vocab over "model" (the tied
    table's rows, which also split the untied head's columns: both are
    the "vocab" axis)."""
    return model_split(rules, "embed/table", (cfg.vocab, cfg.d_model), 0)


def _embed(params, tokens, cfg: ModelConfig, patches=None):
    """The embedded stream, ``patches`` (if given) before the text, in the
    activation dtype; under sequence parallelism (a text stream) this
    rank's part of it (a vocab-parallel embedding's partial rows
    reduce-scattered)."""
    rules = training_rules()
    split = rules is not None and _vocab_split(rules, cfg)
    sp = seq_parallel(rules)
    if split:
        x = L.embed_vocab_parallel(params["embed"], tokens, rules,
                                   partial=sp)
    else:
        x = L.embed(params["embed"], tokens)
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], 1)
    x = x.to(cfg.activation_dtype)
    if not sp:
        return x
    return seq_scatter(x, rules) if split else seq_part(x, rules)


def loss_fn(params, batch, cfg: ModelConfig, tcfg: TrainConfig, specs=None):
    """batch: tokens [B, S] int, or {"tokens": ..., "patches": [B, P, D]}
    for the stubbed-frontend VLM archs (loss over the text positions).

    Under training's rules ``params`` are this rank's blocks (``specs``
    their specs, :func:`param_specs` by default), ``batch`` its rows, and
    the result is its share of the global mean: the data ranks' shares sum
    to it.  Sequence parallelism splits a text stream that "model"
    divides; a stream with patches stays whole."""
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    patches = batch.get("patches") if isinstance(batch, dict) else None
    rules = training_rules()
    if rules is None:
        return _loss(params, tokens, patches, cfg, tcfg)
    specs = param_specs(cfg, rules) if specs is None else specs
    rules = seq_rules(rules, None if patches is not None else
                      tokens.shape[1])
    with use_rules(rules):
        return _loss(T.gather_weights(rules, params, specs), tokens,
                     patches, cfg, tcfg)


def _loss(params, tokens, patches, cfg: ModelConfig, tcfg: TrainConfig):
    x = _embed(params, tokens, cfg, patches)
    n_patch = 0 if patches is None else patches.shape[1]
    positions = torch.arange(n_patch + tokens.shape[1], device=x.device)
    h, _, aux = T.run_segments(params, x, positions, cfg)
    if n_patch:
        h = h[:, n_patch:]                 # loss over the text positions
        positions = positions[: h.shape[1]]
    hn = L.norm(params["final_norm"], h)
    loss = chunked_lm_loss(hn, params, tokens, cfg) + aux
    if cfg.mtp:
        # MTP shares the trunk: one extra block over [h_t ; emb(t+1)]
        # predicting token t+2 (the chunked head again).
        emb_next = _embed(params, torch.roll(tokens, -1, 1), cfg)
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


def _compress_int8(g, err, fused: bool = False):
    """(int8 values, scale, residual).  ``fused``: the residual ``gf - q *
    scale`` rounded once, as the jitted reference's fused multiply-subtract
    rounds it (its all-reduce); otherwise the product is rounded first, as
    its eager ``compress_grads`` does."""
    gf = g.float() + err
    scale = torch.clamp(gf.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    if fused:    # q * scale is exact in f64: one rounding, to f32
        return q, scale, (gf.double() - q.double() * scale.double()).float()
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
    """The reference's int8 all-reduce over the data axes with error
    feedback, on this rank's tensors: each rank quantizes its ``g + e``
    with its own per-leaf scale, the int8 values go on the wire (one
    ``all_gather`` along the first axis, then int32 partial sums along any
    other) and are summed as int32 in coordinate order, the scales' max is
    taken, and the result is ``q_sum * s_max / n``; ``err`` is the rank's
    own residual.  That is the mean only where every rank's scale is equal,
    as it is in the reference's step, which calls it on gradients already
    reduced over the data ranks (ROADMAP C14).  ``mesh`` is a
    ``DeviceMesh``; data axes it lacks are skipped."""
    if mesh is None or isinstance(mesh, AbstractMesh):
        raise ValueError("allreduce_int8_ef needs the ranks' DeviceMesh: it "
                         "is the data all-reduce of mesh training")
    shape = mesh_shape(mesh)
    axes = tuple(a for a in data_axes if a in shape)
    n = 1
    for a in axes:
        n *= shape[a]

    def body(g, e):
        q, scale, e_new = _compress_int8(g, e, fused=True)
        q_sum, s_max = q, scale.reshape(1)
        for a in axes:
            parts = dim_all_gather(mesh, q_sum, a).to(torch.int32)
            q_sum = functools.reduce(torch.add, parts.unbind(0))
            s_max = dim_max(mesh, s_max, a)
        return q_sum.float() * s_max[0] / n, e_new

    out = tree_map(body, grads, err_state)
    return (tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out))


def _allreduce_int8_ef_blocks(rules, grads, err, specs, data_axes):
    """:func:`allreduce_int8_ef` in the reference's layout, leaf by leaf:
    the reference's step hands it whole, data-replicated gradients (its
    ``shard_map`` in_specs are replicated), so each leaf and its residual
    are gathered whole, reduced, and cut back to this rank's block."""
    def leaf(g, e, spec):
        out, e_new = allreduce_int8_ef(gather_shards(rules, g, spec),
                                       gather_shards(rules, e, spec),
                                       rules.mesh, data_axes)
        return local_shard(rules, out, spec), local_shard(rules, e_new, spec)

    pairs = tree_map(leaf, grads, err, specs)
    return (tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs))


def param_specs(cfg: ModelConfig, rules):
    """The spec of every parameter of ``cfg`` under ``rules``, from its
    full shapes (an init on the "meta" device: nothing is drawn or
    held)."""
    return rules.tree_pspecs(T.init_model(cfg, torch.Generator(), "meta"))


def state_specs(cfg: ModelConfig, tcfg: TrainConfig, rules):
    """The specs of the train state's leaves: moments and the error
    feedback split as their parameter, ``opt/step`` whole."""
    ps = param_specs(cfg, rules)
    out = {"params": ps, "opt": {"m": ps, "v": ps, "step": ()}}
    if tcfg.grad_compression == "int8_ef":
        out["err"] = ps
    return out


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def value_and_grad(params, batch, cfg: ModelConfig, tcfg: TrainConfig,
                   specs=None):
    """(loss, grads) of :func:`loss_fn`; grads mirror ``params`` (zeros
    for a leaf the loss does not reach).  Under training's rules the loss
    is the global one (the data ranks' shares summed) and each gradient
    this rank's block of the global gradient."""
    leaves = tree_leaves(params)
    loss = loss_fn(params, batch, cfg, tcfg, specs)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    loss = loss.detach()
    rules = training_rules()
    if rules is not None:
        loss = batch_sum(rules, loss)
    return loss, tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns step(state, tokens) -> (state, metrics).  The update writes
    the state's parameters and moments in place (``adamw_update``).  Under
    training's rules (``use_rules``) ``state`` is this rank's blocks and
    ``tokens`` its rows of the batch."""
    specs_of = {"rules": None, "specs": None}

    def grads_of(params, tokens, specs):
        if tcfg.microbatches <= 1:
            return value_and_grad(params, tokens, cfg, tcfg, specs)
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
            loss, g = value_and_grad(params, batch, cfg, tcfg, specs)
            g_acc = tree_map(torch.add, g_acc, g)
            loss_acc = loss_acc + loss
        inv = 1.0 / n
        return loss_acc * inv, tree_map(lambda g: g * inv, g_acc)

    def step(state, tokens):
        params, opt, err = state["params"], state["opt"], state.get("err")
        rules, specs = training_rules(), None
        if rules is not None:
            if specs_of["rules"] is not rules:
                specs_of.update(rules=rules, specs=param_specs(cfg, rules))
            specs = specs_of["specs"]
        loss, grads = grads_of(params, tokens, specs)
        if tcfg.grad_compression == "int8_ef" and err is not None and \
                rules is not None:
            data_axes = tuple(a for a in ("pod", "data") if a in rules.shape)
            grads, err = _allreduce_int8_ef_blocks(rules, grads, err, specs,
                                                   data_axes)
        lr_scale = cosine_schedule(opt["step"], warmup=tcfg.warmup_steps,
                                   total=tcfg.total_steps)
        params, opt, metrics = adamw_update(params, grads, opt,
                                            tcfg.optimizer, lr_scale,
                                            rules=rules, specs=specs)
        new_state = dict(state, params=params, opt=opt)
        if err is not None:
            new_state["err"] = err
        return new_state, dict(metrics, loss=loss)

    return step


def trainable(params):
    """``params`` with every leaf set to require gradients (in place)."""
    return tree_map(lambda p: p.requires_grad_(True), params)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: torch.Generator, device=None, place=None):
    """Seeded parameters (``transformer.init_model``, each part through
    ``place`` where given: a rank's blocks), zero moments and, with
    ``grad_compression="int8_ef"``, a zero error-feedback tree, shaped as
    the parameters kept."""
    params = trainable(T.init_model(cfg, generator, device, place))
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

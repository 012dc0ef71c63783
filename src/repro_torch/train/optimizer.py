"""AdamW in plain torch, over the port's parameter tree.

Counterpart of ``repro/train/optimizer.py``.  A tree is nested dicts and
lists of tensors (the port's parameter layout); the optimizer state mirrors
it (``m``, ``v``) beside a 0-d int32 ``step``.  Options: bf16 moments
(``moment_dtype="bfloat16"``, half the optimizer memory) and decoupled
weight decay.

The arithmetic is the reference's, operation for operation in f32.
Under mesh training each rank updates its blocks; the clip and the
``grad_norm`` metric take the global norm over every rank's blocks
(:func:`global_norm` with ``rules`` and ``specs``).  The
update runs under ``torch.no_grad()`` and writes the parameters and moments
in place on their device (the reference returns new trees; the port's
full-width state would need a second copy of parameters and moments
otherwise), and returns the same trees.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # "bfloat16" halves optimizer memory


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure: dicts and lists are nodes, anything
    else (a tensor, a tuple) is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def init_opt_state(params, cfg: AdamWConfig):
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, rules=None, specs=None) -> torch.Tensor:
    """The L2 norm of every leaf together.  With mesh ``rules``, ``tree``
    holds this rank's blocks (``specs`` their specs): each block's sum of
    squares counts once (on the rank with its first copy,
    ``sharding/api.py:holds_first_copy``), summed over the mesh in rank
    order, so every rank gets the same norm."""
    leaves = tree_leaves(tree)
    if rules is None:
        total = sum(torch.sum(torch.square(g.float())) for g in leaves)
        return torch.sqrt(total)
    from repro_torch.sharding.api import holds_first_copy, mesh_sum
    part = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g, spec in zip(leaves, tree_leaves(specs)):
        if holds_first_copy(rules, spec):
            part = part + torch.sum(torch.square(g.float()))
    return torch.sqrt(mesh_sum(rules, part))


def clip_by_global_norm(grads, max_norm: float, rules=None, specs=None):
    """Returns (clipped grads, global norm before clipping)."""
    gnorm = global_norm(grads, rules, specs)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def _clip_scale(gnorm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0,
                 rules=None, specs=None):
    """One AdamW step with global-norm clipping.  Writes ``params`` and the
    moments in place and returns (params, state, metrics).  Under mesh
    ``rules`` the trees are this rank's blocks (``specs``) and the norm is
    global."""
    gnorm = global_norm(grads, rules, specs)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    sf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)
    lr = cfg.lr * lr_scale
    if not torch.is_tensor(lr):
        lr = torch.tensor(lr, dtype=torch.float32, device=sf.device)

    def upd(p, g, m, v):
        gf = (g.float() * scale).to(g.dtype).float()
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        mh = m_new / bc1
        vh = v_new / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)

    tree_map(upd, params, grads, state["m"], state["v"])
    state = dict(state, step=step.to(torch.int32))
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def cosine_schedule(step, *, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """Linear warm-up, then a cosine from 1 down to ``min_ratio`` (f32)."""
    s = torch.as_tensor(step).float()
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)

"""Mixture-of-Experts FFN: shared + routed experts, top-k, capacity-based.

Counterpart of ``repro/models/moe.py`` on one device.  Dispatch is sort +
capacity buffers: the (token, expert) rows are bucketed into an
``[E, capacity, D]`` buffer by (expert, position-in-expert), run through
one batched product per FFN weight and gathered back; rows beyond an
expert's capacity are dropped, as in the reference.  The reference runs
these products outside any Pallas kernel, so they are batched torch
products here.

Which rows drop is an integer observable and equals the reference's: the
slot within an expert comes from a stable sort of the rows in (token, k)
order, and every row of the call is routed, pad rows included.  Each row
that fits is written to a place of its own, and the combine sums each
token's k rows in a fixed order, so a call gives the same bits on every
run (a float scatter-add on the card sums in atomic order).  Nothing in
the dispatch reads a value back to the host but one number in mesh
training: the length of a data rank's longest run of slots
(:func:`dispatch`).

Under a mesh (``PagedEngine`` with ``ServeConfig.mesh``) every rank holds
every token's rows (the dense layers run replicated), so every rank
routes the same tokens to the same experts with the same bits, and the
capacity is the single-device one.  A "model" dim of 1 runs the
single-device path on every rank, as the reference does; a larger one runs
the reference's branch (``sharding/rules.py:moe_branch``):

* **resident** (``MoEConfig.resident`` and data x model divides
  ``n_routed``): this rank holds experts ``[(d * tp + m) * n_local, ...)``;
* **EP** ("model" divides ``n_routed``): this rank holds experts
  ``[m * n_local, ...)``;
* **expert-TP** (otherwise): this rank holds every expert with its
  1/tp share of the hidden units (``wi_gate``/``wi_up`` columns, ``wo``
  rows).

A rank runs the dispatch at its expert offset on all rows.  In EP and
resident each (token, k) pair is computed by exactly one rank (its
expert's), at the single-device capacity, so its row has the
single-device bits; the rows are put together by one all-gather, each
taken from its owner (``sharding/api.py:gather_owned``; no float sum
crosses ranks), and each token's k rows summed in the single-device
order: ``out`` equals one device's bit for bit wherever each expert's
product does.  Expert-TP splits the hidden contraction: its partial rows
are all-gathered and summed in rank order (the same result on every rank,
within float rounding of one device's), then weighted and summed over k.
The reference's EP and expert-TP branches split the tokens over "data"
and take the capacity of a data shard's rows, so where capacity binds its
drops differ from its own single device (ROADMAP C11).

Under training's rules (``sharding/rules.py:make_rules``) a data rank
holds only its own rows, and the branch follows the rules' layout
(:func:`_train_moe`, ``sharding/rules.py:moe_train_branch``): EP where the
experts lie over "model", expert-TP where their hidden units do, resident
where they lie over data x model.  The routing ids of every data rank are
gathered, so the plan, the capacity and the drops are one device's, and
each data rank adds its share of one device's aux loss.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding.api import (batch_dims, batch_gather, batch_sum,
                                      block_index, enter_model, gather_owned,
                                      gather_rows, gather_shards, leave_model,
                                      mesh_shape, model_split,
                                      reduce_from_model, scatter_rows,
                                      seq_parallel, seq_part, training_rules)
from repro_torch.sharding.rules import (expert_slice, make_serve_rules,
                                        moe_branch, moe_train_branch)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_routed: int
    top_k: int
    d_expert: int                  # per-expert ffn hidden dim
    n_shared: int = 0              # shared experts (always active)
    d_shared: int = 0              # shared-expert hidden (total)
    act: str = "swiglu"
    norm_topk: bool = True         # renormalize top-k probs to sum 1
    router_scale: float = 1.0
    aux_loss_coef: float = 0.001
    capacity_factor: float = 1.25  # per-expert token capacity multiplier
    resident: bool = False         # decode under a mesh: experts over
                                   # data x model, one block per rank


def init_moe(generator, cfg: MoEConfig, device=None, dtype=torch.float32):
    E, D, H = cfg.n_routed, cfg.d_model, cfg.d_expert
    p = {
        "router": L.init_linear(generator, D, E, False, device,
                                torch.float32),
        "wi_gate": L.truncated_normal_init(generator, (E, D, H), 1.0, device,
                                           dtype),
        "wi_up": L.truncated_normal_init(generator, (E, D, H), 1.0, device,
                                         dtype),
        "wo": L.truncated_normal_init(generator, (E, H, D), 1.0, device,
                                      dtype),
    }
    if cfg.n_shared:
        p["shared"] = L.init_mlp(generator, D, cfg.d_shared, cfg.act, False,
                                 device, dtype)
    return p


def _route_rows(p, x, cfg: MoEConfig):
    """x [..., D] -> (probs [..., E], weights [..., k], expert ids [..., k])."""
    logits = L.linear(p["router"], x.float()) * cfg.router_scale
    probs = torch.softmax(logits, dim=-1)
    # A tie inside topk could only reorder one token's k entries; it moves
    # no slot, because a token meets each expert at most once and slots
    # follow the (token, k) order of the rows within one expert.
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def _count(key, n: int, where=None):
    """Rows per key in [0, n) (those ``where`` marks, if given): an integer
    scatter-add, exact in any order (``torch.bincount`` reads its input's
    max back to the host on the card)."""
    ones = torch.ones_like(key) if where is None else where.long()
    return torch.zeros(n, dtype=torch.int64, device=key.device).scatter_add_(
        0, key, ones)


def _aux_loss(probs, top_i, cfg: MoEConfig):
    """Switch-style load-balance loss of probs [T, E], top_i [T, k]."""
    T = probs.shape[0]
    counts = _count(top_i.reshape(-1).long(), cfg.n_routed)
    density = counts.float() / float(T * cfg.top_k)
    return cfg.n_routed * torch.sum(density * probs.mean(0)) \
        * cfg.aux_loss_coef


def _aux_loss_share(probs, top_i, cfg: MoEConfig, rules):
    """This data rank's share of one device's :func:`_aux_loss` over the
    whole batch: the expert counts summed over the data ranks (integers,
    exact), the probabilities of this rank's rows summed, both over the
    global token count.  The shares sum to one device's loss, and each
    rank's router gradient is that of its own rows.  ``probs`` may be a
    part of the rows ``top_i`` routes (a "model" rank's part of the
    sequence): the parts' shares then sum to the rows' share."""
    counts = batch_sum(rules, _count(top_i.reshape(-1).long(),
                                     cfg.n_routed))
    n = top_i.shape[0] * block_index(rules, rules.axis_map.get("batch"))[1]
    density = counts.float() / float(n * cfg.top_k)
    return cfg.n_routed * torch.sum(density * probs.sum(0)) / n \
        * cfg.aux_loss_coef


MIN_CAPACITY = 8


def _capacity(T: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(factor * T * top_k / max(n_experts, 1))
    return max(MIN_CAPACITY, -(-c // 8) * 8)   # a multiple of 8


def dispatch_plan(top_i, n_local: int, capacity: int, expert_offset: int = 0):
    """Where each routed row goes: ``(order, e_idx, s_idx, valid)``.

    Row r = t * k + j is token t's j-th expert; ``order`` sorts the rows
    stably by local expert (non-local experts last), and sorted row i sits
    at slot ``s_idx[i]`` of expert ``e_idx[i]`` when ``valid[i]``, else it
    is dropped (beyond capacity, or not this shard's)."""
    R = top_i.numel()
    dev = top_i.device
    local = top_i.reshape(R).long() - expert_offset
    is_local = (local >= 0) & (local < n_local)
    key = torch.where(is_local, local, torch.full_like(local, n_local))
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    gs = _count(key, n_local + 1)[:n_local]
    starts = torch.cat([gs.new_zeros(1), torch.cumsum(gs, 0)])[:-1]
    slot = torch.arange(R, device=dev) - starts[
        torch.clamp(sorted_key, 0, n_local - 1)]
    valid = (sorted_key < n_local) & (slot < capacity)
    zero = torch.zeros_like(sorted_key)
    for log in RoutingLog.open_logs:
        log.plans.append((top_i.detach(), order,
                          is_local[order] & ~valid))
    return (order, torch.where(valid, sorted_key, zero),
            torch.where(valid, slot, zero), valid)


class RoutingLog:
    """What the MoE calls route while the log is open (``with RoutingLog()
    as log:``), for drop and routing checks: ``plans`` holds, per
    :func:`dispatch_plan` call, its routing ids ``top_i``, its row order
    and which sorted rows dropped among the experts it plans; ``routes``,
    per :func:`moe_ffn` call, its router probabilities (this rank's rows)
    and aux loss (a data rank's share in mesh training).  They stay on the
    device until read."""

    open_logs: list = []

    def __init__(self):
        self.plans, self.routes = [], []

    def __enter__(self):
        RoutingLog.open_logs.append(self)
        return self

    def __exit__(self, *exc):
        RoutingLog.open_logs.remove(self)

    def counts(self) -> list[int]:
        """Each plan's dropped (token, expert) pairs, counted."""
        return [int(d.sum()) for _, _, d in self.plans]

    def pairs(self) -> list[list[tuple[int, int]]]:
        """Each plan's dropped (token, expert) pairs, sorted; tokens are
        numbered as the plan routes them (the whole batch's in mesh
        training)."""
        out = []
        for top_i, order, dropped in self.plans:
            flat, k = top_i.reshape(-1).tolist(), top_i.shape[-1]
            out.append(sorted((r // k, flat[r])
                              for r in order[dropped].tolist()))
        return out

    def take(self):
        """The plans and routes so far, and the log emptied."""
        out = self.plans, self.routes
        self.plans, self.routes = [], []
        return out


def _bmm(a, b):
    """Batched product with f32 results (the reference's
    ``preferred_element_type``); narrower operands widen exactly."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        a, b = a.float(), b.float()
    return torch.bmm(a, b)


def dispatch(x2d, top_i, cfg: MoEConfig, n_local: int, capacity: int,
             expert_offset: int = 0, token_offset: int = 0):
    """The expert buffer ``[n_local, slots, D]`` and the plan that filled
    it, ``(order, e_idx, s_idx, write)``: sorted row i sits at slot
    ``s_idx[i]`` of expert ``e_idx[i]`` where ``write[i]``.  Every row is
    written, with no boolean index (each would sync the host): a row that
    fits lands at its (expert, slot), one unique place, and every other
    row at a spare last row that is cut off.

    ``top_i`` may route more tokens than ``x2d`` holds (every data rank's,
    in training on a mesh): ``x2d`` then holds tokens ``[token_offset,
    ...)`` and only their rows are written.  Slots go in token order, so
    those rows fill one run of each expert's slots in the whole plan; the
    buffer holds each run from its start, padded to the longest (one read
    of its length on the host), and not the other data ranks' slots."""
    T, D = x2d.shape
    order, e_idx, s_idx, write = dispatch_plan(top_i, n_local, capacity,
                                               expert_offset)
    tok = torch.arange(top_i.shape[0], device=x2d.device).repeat_interleave(
        cfg.top_k)[order] - token_offset
    slots = capacity
    if top_i.shape[0] != T:
        mine = (tok >= 0) & (tok < T)
        first = _count(e_idx, n_local, write & (tok < 0))
        run = int(_count(e_idx, n_local, write & mine).max())
        slots = min(capacity, max(MIN_CAPACITY, -(-run // 8) * 8))
        write = write & mine
        s_idx = torch.where(write, s_idx - first[e_idx],
                            torch.zeros_like(s_idx))
        tok = torch.clamp(tok, 0, T - 1)
    spare = n_local * slots
    dest = torch.where(write, e_idx * slots + s_idx,
                       torch.full_like(e_idx, spare))
    buf = x2d.new_zeros((spare + 1, D))
    buf[dest] = x2d[tok]
    return buf[:spare].view(n_local, slots, D), (order, e_idx, s_idx,
                                                 write)


# The batched expert products run in calls of ``n_routed / EXPERT_SHARDS``
# experts (all of them where that does not divide): on the card cuBLAS picks
# its kernel by the batch count too (at 8-slot buffers 15 or 30 experts get
# other bits than 60, measured on the H100), so a call of a fixed number of
# experts gives an expert the same bits on one device and on a rank that
# holds a 1/2 or 1/4 block of the experts (EP, resident).
EXPERT_SHARDS = 4


def _experts(buf, p_w, cfg: MoEConfig, dtype):
    n = cfg.n_routed // EXPERT_SHARDS
    if cfg.n_routed % EXPERT_SHARDS or buf.shape[0] % n:
        n = buf.shape[0]
    actf = F.silu if cfg.act == "swiglu" else L.gelu
    out = []
    for e in range(0, buf.shape[0], n):
        x = buf[e:e + n]
        a = _bmm(x, p_w["wi_gate"][e:e + n])
        b = _bmm(x, p_w["wi_up"][e:e + n])
        h = (actf(a) * b).to(dtype)
        out.append(_bmm(h, p_w["wo"][e:e + n]))
    return out[0] if len(out) == 1 else torch.cat(out)


def _pair_rows(p_w, x2d, top_p, top_i, cfg: MoEConfig, expert_offset: int,
               n_local: int, capacity: int, split: bool = False,
               token_offset: int = 0):
    """One shard's routed-expert compute: each (token, k) pair's expert
    output ``[T, k, D]``, weighted by its routing probability (unweighted
    with ``top_p`` None), zero where the pair is dropped or another
    shard's.  ``top_i`` may route every data rank's tokens (training on a
    mesh; :func:`dispatch`): the rows of ``x2d``'s tokens come back.

    With ``split`` (a speculative verify) the expert products run on
    slices of ``MIN_CAPACITY`` slots, the decode's buffer: on the card a
    row's bits depend on the product's shape, and this gives each verify
    row the bits a decode gives it (ROADMAP facts, ``layers.by_column``)."""
    T, D = x2d.shape
    k = cfg.top_k
    buf, (order, e_idx, s_idx, valid) = dispatch(
        x2d, top_i, cfg, n_local, capacity, expert_offset, token_offset)
    if split:
        y_buf = torch.cat([_experts(buf[:, c:c + MIN_CAPACITY].contiguous(),
                                    p_w, cfg, x2d.dtype)
                           for c in range(0, buf.shape[1], MIN_CAPACITY)], 1)
    else:
        y_buf = _experts(buf, p_w, cfg, x2d.dtype)
    # Back to (token, k) order: each of x2d's rows read from its sorted
    # place.
    at = torch.empty_like(order)
    at[order] = torch.arange(order.numel(), device=order.device)
    at = at[token_offset * k:(token_offset + T) * k]
    y = y_buf[e_idx[at], s_idx[at]] * valid[at, None]
    if top_p is not None:
        y = y * top_p.reshape(-1)[:, None]
    return y.view(T, k, D)


def _sum_pairs(y_flat):
    """Each token's k rows summed in k order: [T, k, D] -> [T, D]."""
    out = torch.zeros_like(y_flat[:, 0])
    for j in range(y_flat.shape[1]):
        out = out + y_flat[:, j]
    return out


def _local_moe(p_w, x2d, top_p, top_i, cfg: MoEConfig, expert_offset: int,
               n_local: int, capacity: int, split: bool = False):
    """One shard's routed-expert compute summed per token (the
    single-device path): ``[T, D]``."""
    return _sum_pairs(_pair_rows(p_w, x2d, top_p, top_i, cfg, expert_offset,
                                 n_local, capacity, split))


def _mesh_moe(p, x2d, top_p, top_i, cfg: MoEConfig, mesh, branch: str,
              capacity: int, split: bool):
    """The routed experts on this rank of ``mesh`` under ``branch`` ("ep",
    "resident" or "tp"), combined across ranks: ``[T, D]`` on every rank."""
    rules = make_serve_rules(mesh, cfg.n_routed, cfg.resident)
    tp = rules.shape["model"]
    if branch == "tp" and cfg.d_expert % tp:
        raise ValueError(
            f"expert-TP splits d_expert={cfg.d_expert} over a 'model' dim "
            f"of {tp}, which does not divide it")
    w = expert_slice(rules, p, cfg.n_routed, cfg.d_expert)
    if branch == "tp":
        part = _pair_rows(w, x2d, None, top_i, cfg, 0, cfg.n_routed,
                          capacity, split)
        parts = gather_shards(rules, part[None], ("model", None, None, None))
        y = parts[0]
        for r in range(1, tp):
            y = y + parts[r]
        return _sum_pairs(y * top_p[..., None])
    dims = ("data", "model") if branch == "resident" else "model"
    n_local = w["wi_gate"].shape[0]
    idx, _ = block_index(rules, dims)
    part = _pair_rows(w, x2d, top_p, top_i, cfg, idx * n_local, n_local,
                      capacity, split)
    return _sum_pairs(gather_owned(rules, part, top_i // n_local, dims))


def _train_moe(p, x, top_p, top_i, cfg: MoEConfig, rules):
    """The routed experts under training's ``rules``: x [B, S, D], this
    rank's tokens -> their output, whole on every "model" rank (under
    sequence parallelism this rank's part of the sequence).

    The drops are one device's: the routing ids of every data rank are
    gathered in batch order (one device's token order), the plan is the
    whole batch's at its capacity, and this rank computes the rows of its
    own tokens, each expert's run of them (:func:`dispatch`).  Only those
    rows run in the split region, entered through ``enter_model`` (the
    gradient of ``x`` summed over "model"): under EP a rank computes its
    block of experts' rows and each pair is taken from its owner
    (``gather_owned``), under expert-TP every expert's rows on its share
    of the hidden units, summed over "model" in rank order
    (``reduce_from_model``).  The ``top_p`` weights and the sum
    over k then run whole on every rank, so the router's gradient is whole
    too, as on one device.  Under sequence parallelism each rank weighs
    and sums its own pairs (EP) or partial rows (expert-TP), and the sums
    are reduce-scattered along the sequence.

    Resident experts (over data x model) each see the whole batch: every
    data rank's tokens and weights are gathered (``gather_rows``), a rank
    runs its own experts' slots, weighs and sums its pairs, and the sums
    come back to each data rank's rows (``scatter_rows``), then leave
    as a partial sum over "model".
    Over a "pod" dim, whose ranks hold the same experts, each pod runs its
    own rows of the whole batch's plan, and the experts' gradients are
    summed over "pod" (``transformer.gather_weights``)."""
    branch = moe_train_branch(rules, cfg.n_routed, cfg.d_model,
                              cfg.d_expert)
    B, S, D = x.shape
    x2d = x.reshape(B * S, D)
    every = batch_gather(rules, top_i)
    cap = _capacity(every.shape[0], cfg.top_k, cfg.n_routed,
                    cfg.capacity_factor)
    t0 = block_index(rules, rules.axis_map.get("batch"))[0] * x2d.shape[0]
    if branch == "resident":
        # The experts lie over "data" (and "model"): their data ranks'
        # rows come together (all of them but over an outer "pod", whose
        # ranks hold the same experts and run their own pod's rows).
        expert = rules.axis_map["expert"]
        dims = tuple(d for d in batch_dims(rules) if d in (
            (expert,) if isinstance(expert, str) else expert))
        n_local = p["wi_gate"].shape[0]
        offset = block_index(rules, expert)[0] * n_local
        x_all = gather_rows(rules, enter_model(x2d, rules), dims)
        w_all = gather_rows(rules, enter_model(top_p, rules), dims)
        n = x_all.shape[0]                   # the gathered ranks' tokens
        pairs = _pair_rows(p, x_all, None, every, cfg, offset, n_local, cap,
                           token_offset=t0 // n * n)
        return leave_model(scatter_rows(rules, _sum_pairs(
            pairs * w_all[..., None]).view(-1, S, D), dims), rules)
    n_local, offset = cfg.n_routed, 0
    if branch == "ep":
        n_local = p["wi_gate"].shape[0]
        offset = block_index(rules, "model")[0] * n_local
    x_in = x2d if branch == "whole" else enter_model(x2d, rules)
    pairs = _pair_rows(p, x_in, None, every, cfg, offset, n_local, cap,
                       token_offset=t0)
    partial = branch != "whole" and seq_parallel(rules)
    if branch == "ep" and not partial:
        pairs = gather_owned(rules, pairs, top_i // n_local, "model")
    elif branch == "tp" and not partial:
        pairs = reduce_from_model(pairs, rules)
    out = _sum_pairs(pairs * top_p[..., None]).view(B, S, D)
    return leave_model(out, rules, partial)


def moe_ffn(p, x, cfg: MoEConfig, mesh=None, split: bool = False):
    """Full MoE block.  x [B, S, D] -> (out, aux_loss).

    With ``split`` (a speculative verify) the per-token parts, the router
    and the shared experts, run position by position as a decode makes
    them (``layers.by_column``); the routed experts see every token of the
    call with the call's capacity, as in the reference.  So a verify can
    drop pairs that a decode of the same tokens keeps, and then its tokens
    differ from plain decoding's, in the reference too (ROADMAP C9)."""
    B, S, D = x.shape
    if split and S > 1:
        cols = [_route_rows(p, x[:, s:s + 1].contiguous(), cfg)
                for s in range(S)]
        probs, top_p, top_i = (torch.cat(c, 1) for c in zip(*cols))
    else:
        probs, top_p, top_i = _route_rows(p, x, cfg)
    probs = probs.reshape(B * S, -1)
    top_p = top_p.reshape(B * S, -1)
    top_i = top_i.reshape(B * S, -1)
    train = training_rules()
    if train is not None:
        if seq_parallel(train):
            # This rank's part of the sequence: the parts' shares summed
            # over "model" (each rank's gradient its part's).
            part = seq_part(probs.view(B, S, -1), train)
            aux = reduce_from_model(_aux_loss_share(
                part.reshape(-1, part.shape[-1]), top_i, cfg, train), train)
        else:
            aux = _aux_loss_share(probs, top_i, cfg, train)
        out = _train_moe(p, x, top_p, top_i, cfg, train)
    else:
        aux = _aux_loss(probs, top_i, cfg)
        cap = _capacity(B * S, cfg.top_k, cfg.n_routed, cfg.capacity_factor)
        branch = ("single" if mesh is None else
                  moe_branch(mesh_shape(mesh), cfg.n_routed, cfg.resident))
        if branch == "single":
            out2d = _local_moe(p, x.reshape(B * S, D), top_p, top_i, cfg, 0,
                               cfg.n_routed, cap, split and S > 1)
        else:
            out2d = _mesh_moe(p, x.reshape(B * S, D), top_p, top_i, cfg,
                              mesh, branch, cap, split and S > 1)
        out = out2d.reshape(B, S, D)
    for log in RoutingLog.open_logs:
        log.routes.append((probs.detach(), aux.detach()))
    out = out.to(x.dtype)
    if "shared" in p:
        tp = (train if train is not None and model_split(
            train, "shared/wo/w", (cfg.d_shared, D), 0) else None)
        y = L.by_column(lambda t: L.mlp(p["shared"], t, cfg.act, tp), x,
                        split)
        if tp is None:
            y = leave_model(y, train, partial=False)
        out = out + y
    return out, aux

"""Mamba-2 (SSD, state-space duality) mixer.

Counterpart of ``repro/models/ssm.py``: chunked SSD for the cache-free
forward (quadratic attention-like compute within a chunk, a linear
recurrence across chunks, one loop step per chunk) and an O(1) stateful
step for decode.  Layout: in_proj -> [z, x, B, C, dt]; causal depthwise
conv over (x, B, C); SSD; gated RMSNorm; out_proj.

Under training's rules (``sharding/rules.py:make_rules``) the "model"
blocks of the SSM leaves cut across the parts of ``in_proj``'s output
``[z | x | B | C | dt]`` and of ``conv_w``'s channels, so the split is
storage only: ``transformer.gather_weights`` reads every leaf whole, the
block runs whole on every rank, and each gradient lands on the rank's
block (under sequence parallelism the block leaves with this rank's part
of the sequence: ``sharding/api.py:leave_model``).

The decode step handles one token per call.  The reference returns wrong
outputs, with no error, for a call of S > 1 tokens on a cache (it rolls
the conv window by S but convolves and updates the state once); the port
raises ``ValueError`` instead (ROADMAP C8).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding.api import leave_model, training_rules


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def init_ssm(generator, cfg: SSMConfig, device=None, dtype=torch.float32):
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + cfg.n_heads
    return {
        "in_proj": L.init_linear(generator, cfg.d_model, d_in_proj, False,
                                 device, dtype),
        "conv_w": L.truncated_normal_init(generator, (cfg.d_conv,
                                                      cfg.conv_dim), 1.0,
                                          device, dtype),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, cfg.n_heads)).to(
            device=device, dtype=dtype),
        "D": torch.ones((cfg.n_heads,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((cfg.n_heads,), dtype=dtype, device=device),
        "norm": L.init_rmsnorm(cfg.d_inner, device, dtype),
        "out_proj": L.init_linear(generator, cfg.d_inner, cfg.d_model, False,
                                  device, dtype),
    }


def _split_proj(zxbcdt, cfg: SSMConfig):
    di = cfg.d_inner
    return (zxbcdt[..., :di], zxbcdt[..., di:di + cfg.conv_dim],
            zxbcdt[..., di + cfg.conv_dim:])


def causal_conv(x, w, b):
    """Depthwise causal conv1d, x [B, S, C], w [K, C] -> [B, S, C] (no
    activation), summed tap by tap from zero as the reference sums."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def _segsum_decay(log_a):
    """log_a [..., Q] -> [..., Q, Q]: exp(cumsum_i - cumsum_j), lower
    triangle; the upper triangle is masked to -inf before the exp."""
    Q = log_a.shape[-1]
    cum = torch.cumsum(log_a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=log_a.device))
    return torch.exp(torch.where(tri, diff, torch.full_like(diff,
                                                             -torch.inf)))


def _ssd_chunk(state, xq, dtq, la, Bq, Cq, hg: int):
    """One SSD chunk: (state [b, h, n, p] f32, the chunk's inputs) ->
    (new state, y [b, Q, h, p] in ``xq.dtype``)."""
    la, Bq, Cq = la.float(), Bq.float(), Cq.float()
    xd = xq.float() * dtq[..., None]
    cum = torch.cumsum(la, dim=1)                              # [b,Q,h]
    # Intra-chunk (attention-like): scores_ij = (C_i . B_j) * L_ij.
    Lm = _segsum_decay(la.transpose(1, 2))                     # [b,h,Q,Q]
    CB = torch.einsum("bqgn,bkgn->bgqk", Cq, Bq)
    CB = CB.repeat_interleave(hg, dim=1)                       # [b,h,Q,Q]
    y_intra = torch.einsum("bhqk,bkhp->bqhp", CB * Lm, xd)
    # Chunk summary: S_c = sum_j exp(cum_Q - cum_j) B_j xdt_j^T.
    decay_tail = torch.exp(cum[:, -1:, :] - cum)               # [b,Q,h]
    Bh = Bq.repeat_interleave(hg, dim=2)                       # [b,Q,h,n]
    S_c = torch.einsum("bqhn,bqhp,bqh->bhnp", Bh, xd, decay_tail)
    # Inter-chunk: y_t += (C_t . state_prev) * exp(cum_t).
    Ch = Cq.repeat_interleave(hg, dim=2)
    y_inter = torch.einsum("bqhn,bhnp,bqh->bqhp", Ch, state, torch.exp(cum))
    new_state = state * torch.exp(cum[:, -1])[..., None, None] + S_c
    return new_state, (y_intra + y_inter).to(xq.dtype)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD over a full sequence, one loop step per chunk.

    x [b, S, h, p], dt [b, S, h] (post-softplus), A [h] (negative),
    B, C [b, S, g, n] -> (y [b, S, h, p], final state [b, h, n, p]).  Where
    a gradient is needed, each chunk step is recomputed in backward (the
    reference's ``jax.checkpoint``): only one chunk's O(Q^2) decay and
    score matrices are ever alive."""
    b, S, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"SSD chunk {Q} does not tile a sequence of {S}")
    log_a = dt * A[None, None, :]
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    step = _ssd_chunk
    if L.needs_grad(x, dt, B, C):
        from torch.utils.checkpoint import checkpoint

        def step(*a):
            return checkpoint(_ssd_chunk, *a, use_reentrant=False)
    ys = []
    for c0 in range(0, S, Q):
        sl = slice(c0, c0 + Q)
        state, y = step(state, x[:, sl], dt[:, sl], log_a[:, sl], B[:, sl],
                        C[:, sl], hg)
        ys.append(y)
    return torch.cat(ys, 1).to(x.dtype), state


def one_token_cache(cache, S: int, mixer: str) -> None:
    """The recurrent decode caches take one token per call (ROADMAP C8)."""
    if cache is not None and S != 1:
        raise ValueError(
            f"a {mixer} cache takes one token per call, got {S}: the "
            f"reference's step would convolve and update the state once "
            f"for all {S} (ROADMAP C8); decode token by token")


def ssm_forward(p, x, cfg: SSMConfig, cache: dict[str, Any] | None = None):
    """Full mixer.  x [B, S, D] -> (out, new_cache)."""
    Bb, S, _ = x.shape
    one_token_cache(cache, S, "ssm")
    zxbcdt = L.linear(p["in_proj"], x)
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if cache is None:
        xBC = F.silu(causal_conv(xBC, p["conv_w"], p["conv_b"]))
    else:
        conv_state = torch.cat(
            [cache["conv"][:, S:], xBC.to(cache["conv"].dtype)], 1)
        window = conv_state[:, -cfg.d_conv:]
        out = torch.einsum("bkc,kc->bc", window, p["conv_w"])
        xBC = F.silu(out + p["conv_b"])[:, None, :]

    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    xs = xBC[..., :di].reshape(Bb, -1, cfg.n_heads, cfg.head_dim)
    Bmat = xBC[..., di:di + gn].reshape(Bb, -1, cfg.n_groups, cfg.d_state)
    Cmat = xBC[..., di + gn:].reshape(Bb, -1, cfg.n_groups, cfg.d_state)

    new_cache = None
    if cache is None:
        y, _ = ssd_chunked(xs, dt, A, Bmat, Cmat, cfg.chunk)
    else:
        hg = cfg.n_heads // cfg.n_groups
        a = torch.exp(dt[:, 0] * A[None, :])                   # [B,h]
        Bh = Bmat[:, 0].repeat_interleave(hg, dim=1)           # [B,h,n]
        Ch = Cmat[:, 0].repeat_interleave(hg, dim=1)
        xdt = xs[:, 0].float() * dt[:, 0][..., None]
        state = cache["ssm"] * a[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bh.float(), xdt)
        y = torch.einsum("bhn,bhnp->bhp", Ch.float(), state)
        y = y[:, None].to(x.dtype)                             # [B,1,h,p]
        new_cache = {"conv": conv_state, "ssm": state}

    y = y + xs * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bb, -1, cfg.d_inner)
    y = L.rms_norm(p["norm"], y * F.silu(z.float()).to(y.dtype))
    out = L.linear(p["out_proj"], y)
    if cache is None:
        out = leave_model(out, training_rules(), partial=False)
    return out, new_cache


def init_ssm_cache(cfg: SSMConfig, batch: int, dtype=torch.float32,
                   device=None):
    return {
        "conv": torch.zeros((batch, cfg.d_conv, cfg.conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                           dtype=torch.float32, device=device),
    }

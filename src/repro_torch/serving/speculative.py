"""Speculative-decoding drafters: who proposes the draft tokens.

Counterpart of ``repro/serving/speculative.py``.  The verify half lives in
:class:`repro_torch.serving.engine.PagedEngine` (one Sq=k+1 BitStopper
verify forward per scheduler tick, longest-matching-prefix acceptance,
block-table rollback of the rejected tail) and is lossless: greedy traces
are identical to non-speculative serving whichever drafter runs and however
bad its guesses are.  Drafters trade proposal quality against cost:

* :class:`NGramDrafter`: prompt lookup, continuing the longest recent
  n-gram match found earlier in the request's own context.  No weights.
* :class:`DraftModelDrafter`: a draft transformer sharing the target's
  vocabulary greedily proposes k tokens, with a cache-free forward over
  the bucket-padded context per token.  Self-drafting with the target
  model is the plumbing-proof default.

A drafter is anything with ``propose(context, k) -> list[int]`` returning
at most k token ids; returning fewer (or none) is always safe.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class Drafter(Protocol):
    def propose(self, context: np.ndarray, k: int) -> list[int]:
        """Given the request's full context (prompt + generated, the last
        entry being the token about to be fed to the target), return up to
        ``k`` proposed continuation tokens."""
        ...


class NGramDrafter:
    """Prompt-lookup self-drafter (no weights).

    Finds the longest suffix n-gram of the context (n from ``max_n`` down
    to ``min_n``) that occurred earlier in the context, and proposes the
    tokens that followed its most recent earlier occurrence."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"({min_n}, {max_n})")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, context: np.ndarray, k: int) -> list[int]:
        ctx = np.asarray(context)
        L = len(ctx)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            pat = ctx[L - n:]
            # Most recent earlier occurrence with at least one follower.
            for s in range(L - n - 1, -1, -1):
                if np.array_equal(ctx[s:s + n], pat):
                    return [int(t) for t in ctx[s + n:s + n + k]]
        return []


class DraftModelDrafter:
    """Greedy draft-transformer proposals (vocabulary shared with the
    target).

    Runs the draft model cache-free over the bucket-padded context once per
    proposed token, a plain loop with no draft KV cache, so the drafter
    stays stateless across admission, eviction and rollback.
    ``max_context`` bounds the context a proposal reads."""

    def __init__(self, cfg, params, max_context: int = 256,
                 bucket: int = 32):
        self.cfg = cfg
        self.params = params
        self.max_context = max_context
        self.bucket = bucket

    @torch.no_grad()
    def propose(self, context: np.ndarray, k: int) -> list[int]:
        from repro_torch.models import transformer as T
        device = self.params["embed"]["table"].device
        toks = [int(t) for t in np.asarray(context)[-self.max_context:]]
        out: list[int] = []
        for _ in range(k):
            L = len(toks)
            Sp = -(-L // self.bucket) * self.bucket
            padded = np.zeros((1, Sp), np.int32)
            padded[0, :L] = toks
            # The trailing zero pad is causally invisible to position L-1.
            logits, _, _ = T.forward(self.params,
                                     torch.as_tensor(padded, device=device),
                                     self.cfg)
            t = int(torch.argmax(logits[0, L - 1]))
            out.append(t)
            toks.append(t)
            if len(toks) > self.max_context:
                toks = toks[-self.max_context:]
        return out


def make_drafter(kind: str, cfg, params, draft_cfg=None, draft_params=None):
    """Resolve ``ServeConfig.speculative`` to a drafter.  ``"draft"`` uses
    the given draft model, else self-drafts with the target model."""
    if kind == "ngram":
        return NGramDrafter()
    if kind == "draft":
        if (draft_cfg is None) != (draft_params is None):
            raise ValueError("draft_cfg and draft_params come together")
        if draft_cfg is None:
            draft_cfg, draft_params = cfg, params
        if draft_cfg.vocab != cfg.vocab:
            raise ValueError(
                f"draft model must share the target vocab "
                f"({draft_cfg.vocab} != {cfg.vocab})")
        return DraftModelDrafter(draft_cfg, draft_params)
    raise ValueError(f"unknown drafter kind {kind!r} (ngram|draft)")

"""Prefill/decode disaggregation: two engine instances, one token stream.

Counterpart of ``repro/serving/frontdoor/disagg.py``.
``DisaggController`` runs a prefill engine and a decode engine as separate
``PagedEngine`` instances (separate pools, separate block numbering) and
moves work between them as :class:`~repro_torch.serving.engine.Prefix`
handles through an in-process :class:`TransferQueue`::

    submit -> controller queue -> prefill_engine.prefill() -> extract()
                                  (chunked prefill,            |
                                   prefix-registry CoW)        v
                                                         TransferQueue
                                                               | detached:
                                                               | K/V/pos rows
                                                               v + scales
        decode stream <- decode_engine.step() <- decode_engine.insert()

``extract`` copies block contents through the pool, so the decode
instance's pool layout is independent; ``insert`` CoW-matches the chain
against the decode pool's own registry first and scatters only blocks it
has not seen.  The controller has the protocol the async door drives
(``submit/begin/step/pending/requests``), so colocated and disaggregated
serving are interchangeable behind ``AsyncFrontDoor``; rids are fixed at
submission and sampling keys are (seed, rid, n), so the tokens are the
synchronous trace's wherever the decode engine's scale grid is the
colocated engine's.

Decode-side oversubscription, speculation and preemption work unchanged:
an inserted slot is a post-preemption resume.  Deadlines re-anchor at
insert (the two engines' tick clocks are unrelated), so ``deadline_ticks``
bounds decode service in this mode.
"""

from __future__ import annotations

import collections

from repro_torch.serving.engine import (InsufficientBlocks, PagedEngine,
                                        Prefix, Request)


class TransferQueue:
    """FIFO of detached prefixes in flight from prefill to decode, with
    transfer accounting."""

    def __init__(self):
        self._q: collections.deque[Prefix] = collections.deque()
        self.counters = {"prefixes_transferred": 0,
                         "blocks_transferred": 0,
                         "payload_bytes": 0}

    def put(self, prefix: Prefix, blocks: int) -> None:
        if prefix.payload is None:
            raise ValueError("transfer queue carries DETACHED prefixes "
                             "only: extract() before put()")
        self.counters["prefixes_transferred"] += 1
        self.counters["blocks_transferred"] += blocks
        self.counters["payload_bytes"] += sum(
            a.nbytes for layer in prefix.payload["layers"]
            for a in layer.values())
        self._q.append(prefix)

    def peek(self) -> Prefix:
        return self._q[0]

    def get(self) -> Prefix:
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)


class DisaggController:
    """Two-instance prefill/decode serving behind the door's backend
    protocol.  One ``step()``: land ready prefixes in free decode slots,
    prefill at most one waiting request to the end, then one decode
    tick."""

    def __init__(self, prefill_engine: PagedEngine,
                 decode_engine: PagedEngine, xfer: TransferQueue = None):
        if (prefill_engine is decode_engine
                or prefill_engine.pool is decode_engine.pool):
            raise ValueError(
                "disaggregation needs two distinct engine instances")
        if prefill_engine.scfg.page_size != decode_engine.scfg.page_size:
            raise ValueError(
                "prefill and decode engines must agree on page_size "
                f"({prefill_engine.scfg.page_size} vs "
                f"{decode_engine.scfg.page_size})")
        # The first token of every request samples on the prefill engine
        # (from the last prefill logits): the instances must agree on
        # everything sampling sees, or the handoff would change tokens.
        for field in ("temperature", "eos_id"):
            a = getattr(prefill_engine.scfg, field)
            b = getattr(decode_engine.scfg, field)
            if a != b:
                raise ValueError(
                    f"prefill and decode engines must agree on {field} "
                    f"({a!r} vs {b!r}): the first token samples on the "
                    f"prefill side")
        self.prefill_engine = prefill_engine
        self.decode_engine = decode_engine
        self.xfer = xfer if xfer is not None else TransferQueue()
        self.queue: collections.deque[Request] = collections.deque()
        self.requests: dict[int, Request] = {}
        self._next_rid = 0
        self.ticks = 0

    def begin(self, seed: int = 0) -> None:
        # Both instances derive the same base key: a token sampled on the
        # decode engine draws under the (seed, rid, n) key the colocated
        # engine would use.
        self.prefill_engine.begin(seed)
        self.decode_engine.begin(seed)

    def submit(self, req: Request) -> Request:
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.slo not in ("besteffort", "standard", "strict"):
            raise ValueError(
                f"slo must be besteffort|standard|strict, got {req.slo!r}")
        if req.rid < 0:
            req.rid = self._next_rid
        elif (req.rid in self.requests
              and self.requests[req.rid] is not req):
            raise ValueError(
                f"rid {req.rid} already belongs to another request")
        self._next_rid = max(self._next_rid, req.rid + 1)
        self.requests[req.rid] = req
        req.submitted_tick = self.ticks
        self.queue.append(req)
        return req

    def pending(self) -> bool:
        return bool(self.queue or len(self.xfer)
                    or self.decode_engine.pending())

    def step(self) -> bool:
        self.ticks += 1
        # 1) Land ready prefixes in free decode slots.  A decode pool too
        # tight for the head prefix retries next tick: finishing requests
        # return capacity.
        while len(self.xfer):
            free = self.decode_engine.free_slots()
            if not free:
                break
            try:
                self.decode_engine.insert(self.xfer.peek(), free[0])
            except InsufficientBlocks:
                break
            self.xfer.get()
        # 2) Prefill at most one waiting request to the end and ship its
        # detached prefix.  A prefill pool too tight retries as well
        # (extract() dropped the previous prefix's references).
        if self.queue and self.prefill_engine.free_slots():
            req = self.queue[0]
            try:
                prefix = self.prefill_engine.prefill(req)
            except InsufficientBlocks:
                pass
            else:
                self.queue.popleft()
                if not prefix.finished:
                    page = self.prefill_engine.scfg.page_size
                    n_ctx = -(-prefix.length // page)
                    self.xfer.put(self.prefill_engine.extract(prefix),
                                  blocks=n_ctx)
        # 3) One decode tick.
        if self.decode_engine.pending():
            self.decode_engine.step()
        return self.pending()

    def run(self, seed: int = 0) -> None:
        self.begin(seed)
        while self.pending():
            self.step()

    def generate(self, requests: list[Request], seed: int = 0):
        for r in requests:
            self.submit(r)
        self.run(seed)
        return requests

    @property
    def counters(self) -> dict:
        """The decode engine's counters (the serving side), the transfer
        queue's as they are, and the prefill engine's under a
        ``prefill_engine_`` prefix."""
        out = dict(self.decode_engine.counters)
        out.update(self.xfer.counters)
        for k, v in self.prefill_engine.counters.items():
            out[f"prefill_engine_{k}"] = v
        return out

"""Paged KV-cache block pool: allocator, refcounts, prefix sharing, and
the budgeted host tier of swap and prefix records.

A copy of ``repro/serving/kv_pool.py``'s ``KVBlockPool`` and ``SwapPool``
(pure Python; importing them from the JAX package would import JAX through
``repro.serving``).

The device side of the paged cache is a batch-free
``[pool_blocks, page_size, Hkv, D]`` K/V pool per attention layer
(:func:`repro_torch.models.attention.init_cache` with a ``PagedLayout``).  This
module is the **host-side** half: which physical block backs which logical
block of which request.  It is pure Python/bookkeeping — no tensors — so the
scheduler can consult it between device steps at zero dispatch cost.

Design (vLLM-style, sized for this repro):

* **Free-list allocator.**  Physical block 0 is reserved as the *null
  block* (backs unused table entries; never written, never allocated).
* **Refcounted blocks.**  A block may appear in several requests' block
  tables at once — copy-on-write prefix sharing.  Only *full* blocks of
  prompt tokens are ever shared, and shared blocks are never rewritten
  (a request's partially-filled tail block is always exclusively owned),
  so "copy-on-write" never actually needs to copy: a request that would
  diverge from a shared block simply allocates its own.
* **Prefix registry.**  Full prompt blocks are registered under the chain
  key of *all* tokens up to the block's end, so a lookup hit guarantees
  the entire prefix matches (no hash-collision false sharing — keys are
  the token tuples themselves).  When the last reference to a registered
  block drops, the block parks in an LRU *cached* pool instead of the
  free list: a later request with the same prefix can resurrect it, and
  allocation pressure evicts the oldest cached block first.
* **Reservations.**  Admission control reserves blocks up front; an
  unreserved :meth:`alloc` never dips into outstanding reservations.  In
  the default (fully-reserved) mode the scheduler reserves the worst-case
  block count for a request (``prompt + max_new_tokens``, minus
  shared-prefix hits), so mid-decode allocation can never fail.  Under
  **oversubscription** (``ServeConfig.oversubscribe``) the scheduler
  reserves only the prompt blocks plus one decode block and handles
  mid-decode exhaustion with victim preemption: :meth:`preempt` returns a
  victim's exclusively-owned blocks to the free list while its shared /
  registered prefix blocks merely drop a reference (parking in the LRU
  cache, resurrectable), so a requeued victim resumes the shared prefix
  for free and recomputes only the unshared tail.  The request lifecycle
  this module backs is documented in ``docs/serving.md``.
"""

from __future__ import annotations

import collections


class KVBlockPool:
    """Host-side block allocator for the paged serving KV cache."""

    def __init__(self, pool_blocks: int, page_size: int,
                 prefix_sharing: bool = True, evict_cb=None):
        if pool_blocks < 2:
            raise ValueError("pool_blocks must be >= 2 (block 0 is the "
                             f"reserved null block), got {pool_blocks}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.pool_blocks = pool_blocks
        self.page_size = page_size
        self.prefix_sharing = prefix_sharing
        # Fired as evict_cb(key, bid) when alloc() steals a parked
        # registered block — BEFORE the new owner can write it, so the
        # caller may still extract the block's device content (the prefix
        # spill path).  Must not call back into the pool.
        self.evict_cb = evict_cb
        self._free: collections.deque[int] = collections.deque(
            range(1, pool_blocks))
        self._ref: dict[int, int] = {}            # live block -> refcount
        self._cached: collections.OrderedDict[tuple, int] = \
            collections.OrderedDict()             # LRU: key -> parked block
        self._registry: dict[tuple, int] = {}     # prefix key -> block
        self._key_of: dict[int, tuple] = {}       # registered block -> key
        self._reserved = 0
        self.peak_live_blocks = 0
        self.alloc_count = 0

    # ------------------------------------------------------------------
    # capacity accounting
    # ------------------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable blocks (everything but the null block)."""
        return self.pool_blocks - 1

    def live_blocks(self) -> int:
        return len(self._ref)

    def available(self) -> int:
        """Blocks an admission could still reserve: free + evictable-cached
        minus outstanding reservations."""
        return len(self._free) + len(self._cached) - self._reserved

    def saturation(self) -> float:
        """Committed fraction of capacity: 1 - available / capacity.
        Counts live blocks AND outstanding reservations (capacity already
        promised is just as unavailable as capacity in use) — the signal
        the engine's load-shedding watermark thresholds on."""
        return 1.0 - self.available() / self.capacity

    def snapshot(self) -> dict:
        """Full allocator state as JSON-serializable plain data, for the
        engine's crash snapshot.  Restore does NOT reinstate it — after a
        host crash the device KV behind these block ids is gone, so a
        restored engine re-claims blocks through the resume path against a
        fresh pool — but persisting it keeps the snapshot a faithful,
        inspectable record of crash-time occupancy (and carries the
        bookkeeping counters across)."""
        return {
            "pool_blocks": self.pool_blocks,
            "page_size": self.page_size,
            "prefix_sharing": self.prefix_sharing,
            "free": list(self._free),
            "ref": {str(bid): n for bid, n in sorted(self._ref.items())},
            "cached": [[list(key), bid]
                       for key, bid in self._cached.items()],
            "registry": [[list(key), bid]
                         for key, bid in sorted(self._registry.items())],
            "reserved": self._reserved,
            "peak_live_blocks": self.peak_live_blocks,
            "alloc_count": self.alloc_count,
        }

    def reserve(self, n: int) -> None:
        if n < 0:
            raise ValueError(f"cannot reserve {n} blocks")
        if n > self.available():
            raise RuntimeError(
                f"reserve({n}): only {self.available()} blocks available")
        self._reserved += n

    def cancel_reservation(self, n: int) -> None:
        if n > self._reserved:
            raise RuntimeError(
                f"cancel_reservation({n}) exceeds outstanding "
                f"{self._reserved}")
        self._reserved -= n

    # ------------------------------------------------------------------
    # allocation / refcounting
    # ------------------------------------------------------------------

    def _track_peak(self) -> None:
        self.peak_live_blocks = max(self.peak_live_blocks, len(self._ref))

    def alloc(self, reserved: bool = False) -> int:
        """Claim a block (refcount 1).  ``reserved=True`` consumes one unit
        of a prior :meth:`reserve`; an unreserved alloc only succeeds when
        a block exists *beyond* outstanding reservations — it must never
        consume capacity another request was promised."""
        if not reserved and self.available() < 1:
            raise RuntimeError(
                f"unreserved alloc: {len(self._free) + len(self._cached)} "
                f"block(s) uncommitted but {self._reserved} reserved — an "
                f"unreserved alloc may not consume a reservation")
        if self._free:
            bid = self._free.popleft()
        elif self._cached:
            key, bid = self._cached.popitem(last=False)   # evict LRU
            del self._registry[key]
            del self._key_of[bid]
            if self.evict_cb is not None:
                # Device content of `bid` is still intact here (the new
                # owner has not written yet; sanitizer poisoning also
                # runs after this returns) — last chance to spill it.
                self.evict_cb(key, bid)
        else:
            raise RuntimeError("KV block pool exhausted")
        if reserved:
            self.cancel_reservation(1)
        self._ref[bid] = 1
        self.alloc_count += 1
        self._track_peak()
        return bid

    def incref(self, bid: int) -> None:
        self._ref[bid] += 1

    def refcount(self, bid: int) -> int:
        """Live references to a block (0: free, parked, or unknown)."""
        return self._ref.get(bid, 0)

    def is_registered(self, bid: int) -> bool:
        """True iff the block is published in the prefix registry (a full
        prompt block other requests may map; it parks rather than frees)."""
        return bid in self._key_of

    def decref(self, bid: int) -> None:
        """Drop one reference; the last drop frees the block — to the LRU
        cached pool if it is a registered prefix block, else the free
        list."""
        n = self._ref[bid] - 1
        if n > 0:
            self._ref[bid] = n
            return
        del self._ref[bid]
        key = self._key_of.get(bid)
        if key is not None and self.prefix_sharing:
            self._cached[key] = bid               # parked, resurrectable
            self._cached.move_to_end(key)
        else:
            if key is not None:
                del self._registry[key]
                del self._key_of[bid]
            self._free.append(bid)

    def rollback(self, bids: list[int], reserve: bool = True) -> None:
        """Return speculative tail blocks to the pool, atomically restoring
        the reservation they were claimed from.

        Speculative decoding materializes blocks for draft-token positions
        out of the request's admission reservation; when the drafts are
        rejected, those blocks hold no live token and must come back — with
        the reservation units re-created so the request's worst-case
        guarantee (mid-decode allocation can never fail) still holds.
        ``reserve=False`` skips the re-reservation: an oversubscribed
        engine claims draft blocks from *spare* (unreserved) capacity, and
        re-reserving those on rollback would earmark shared spare capacity
        to one slot, starving the others into needless preemptions.

        Rolled-back blocks must be **exclusively owned, unregistered**
        scratch: a refcount > 1 block is mapped by another request's table
        and a registered block is a published prompt prefix — rolling
        either back would yank KV out from under a reader (the engine never
        rolls past the prompt/shared boundary; this guards the invariant).
        """
        self._free_exclusive(bids, "rollback")
        # Freed blocks are available again by construction, so re-reserving
        # them cannot fail.
        if reserve:
            self._reserved += len(bids)

    def _free_exclusive(self, bids: list[int], verb: str) -> None:
        """Shared mechanics of :meth:`rollback` and :meth:`preempt`: free
        exclusively-owned, unregistered blocks to the free list.  Validates
        every bid BEFORE mutating anything — a guard firing mid-loop must
        not leave the pool half-reclaimed."""
        for bid in bids:
            if self._ref.get(bid) != 1:
                raise RuntimeError(
                    f"{verb} of block {bid} with refcount "
                    f"{self._ref.get(bid)}: only exclusively-owned blocks "
                    f"may be reclaimed (shared blocks outlive the {verb})")
            if bid in self._key_of:
                raise RuntimeError(
                    f"{verb} of registered prefix block {bid}: published "
                    f"prefix blocks park via decref, never free forcibly")
        for bid in bids:
            del self._ref[bid]
            self._free.append(bid)

    def preempt(self, bids: list[int]) -> None:
        """Forcibly reclaim a preemption victim's exclusively-owned blocks.

        Unlike :meth:`rollback` these blocks held *live* tokens (the victim
        recomputes them on resume via chunked prefill) and no reservation
        is re-created — the scheduler cancels the victim's remaining
        reservation separately and the freed capacity is exactly what the
        preemption exists to hand to other requests.

        Shared and registered blocks must NOT come through here: a
        refcount > 1 block is mapped by another request's table and a
        registered block is a published prompt prefix — both must survive
        the victim (the scheduler ``decref``\\ s them instead, parking
        registered blocks in the LRU cache so resume re-maps them for
        free).  Validation runs before any mutation, so a refused call
        leaves the pool untouched.
        """
        self._free_exclusive(bids, "preempt")

    # ------------------------------------------------------------------
    # prefix sharing
    # ------------------------------------------------------------------

    def register(self, key: tuple, bid: int) -> None:
        """Publish a fully-written prompt block under its prefix chain key.
        First writer wins; re-registration under the same key is a no-op
        (the content is identical by construction)."""
        if not self.prefix_sharing or key in self._registry:
            return
        self._registry[key] = bid
        self._key_of[bid] = key

    def lookup(self, key: tuple) -> int | None:
        """Find a block holding exactly this prefix chunk.  A hit takes a
        reference (resurrecting the block from the cached pool if its last
        owner already finished) — the caller owns the reference."""
        if not self.prefix_sharing:
            return None
        bid = self._registry.get(key)
        if bid is None:
            return None
        if bid in self._ref:
            self.incref(bid)
        else:
            del self._cached[key]
            self._ref[bid] = 1
            self._track_peak()
        return bid

    def registered_items(self) -> list[tuple[tuple, int]]:
        """All published prefix blocks as ``(chain key, bid)`` pairs in
        deterministic (sorted-key) order — live and parked alike.  Every
        registered block is a fully-written prompt block that is never
        rewritten, so its device content is always safe to copy down a
        tier (``PagedEngine.flush_prefixes``)."""
        return sorted(self._registry.items())


class SwapPool:
    """Budgeted host-RAM tier of opaque swap and spill records.

    A copy of ``repro/serving/kv_pool.py:SwapPool``.  Pure bookkeeping,
    like the allocator above (no tensors): records are opaque to the pool
    and sized in bytes by the caller, so swap records of host arrays and
    prefix records fit through the same accounting.  Insertion order is
    the LRU order (:meth:`get` touches).

    Two policies, chosen by ``evict_cb``:

    * ``evict_cb=None``: a :meth:`put` that does not fit is **refused**
      (returns False) and the caller falls back a tier (swap-to-host
      preemption: the victim recomputes on resume, as without swap).
    * ``evict_cb=f``: a put that does not fit first evicts the least
      recently used records, handing each to ``f(key, record, nbytes)``
      (the warm prefix tier: cold records spill down to the disk store
      instead of vanishing).

    Under a mesh every rank keeps its own pools.  A swap record holds the
    rank's KV heads and is sized by the caller as the whole record, so the
    budget admits and refuses what it does on one device; the prefix tier
    keeps whole records on every rank (``PagedEngine``).
    """

    def __init__(self, budget_bytes: int = 0, evict_cb=None):
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.evict_cb = evict_cb
        self._records: collections.OrderedDict = collections.OrderedDict()
        self._nbytes: dict = {}
        self.bytes_used = 0
        self.peak_bytes = 0
        self.put_count = 0
        self.evict_count = 0
        self.refused_count = 0

    def __contains__(self, key) -> bool:
        return key in self._records

    def __len__(self) -> int:
        return len(self._records)

    def keys(self) -> list:
        return list(self._records)

    def nbytes_of(self, key) -> int:
        return self._nbytes.get(key, 0)

    def put(self, key, record, nbytes: int) -> bool:
        """Admit a record under the byte budget, replacing any record under
        the same key.  Returns False (refused, nothing stored) when the
        record cannot fit and there is no ``evict_cb`` to make room."""
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError(f"record nbytes must be >= 0, got {nbytes}")
        if key in self._records:
            self.drop(key)
        if nbytes > self.budget_bytes or (
                self.evict_cb is None
                and self.bytes_used + nbytes > self.budget_bytes):
            self.refused_count += 1
            return False
        while self.bytes_used + nbytes > self.budget_bytes:
            old_key, old_rec = self._records.popitem(last=False)  # LRU
            old_n = self._nbytes.pop(old_key)
            self.bytes_used -= old_n
            self.evict_count += 1
            self.evict_cb(old_key, old_rec, old_n)
        self._records[key] = record
        self._nbytes[key] = nbytes
        self.bytes_used += nbytes
        self.peak_bytes = max(self.peak_bytes, self.bytes_used)
        self.put_count += 1
        return True

    def get(self, key):
        """Peek a record (None on a miss); a hit is an LRU touch."""
        rec = self._records.get(key)
        if rec is not None:
            self._records.move_to_end(key)
        return rec

    def take(self, key):
        """Remove and return a record (None on a miss).  A swap record is
        consumed this way, exactly once, by its resume."""
        if key not in self._records:
            return None
        rec = self._records.pop(key)
        self.bytes_used -= self._nbytes.pop(key)
        return rec

    def drop(self, key) -> None:
        self.take(key)

    def items(self) -> list:
        """(key, record) pairs, LRU-oldest first: a copy, so the pool may
        change while the caller walks it."""
        return list(self._records.items())

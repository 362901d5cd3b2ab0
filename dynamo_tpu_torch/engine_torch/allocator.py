"""Host-side paged KV block allocator with prefix caching and event emission.

Owns the mapping from logical sequences to physical pages of the device KV
pool. Full blocks are content-addressed by their chained sequence hash
(kv/tokens.py), so a new request whose prompt shares a block-aligned prefix
with a cached sequence reuses those pages and skips recomputing them.

Lifecycle of a physical block:
    free → active (refcount ≥ 1, owned by live sequences)
         → cached (refcount 0 but contents valid; reusable by hash, LRU-evictable)
         → free (evicted; `removed` event emitted)

Emits stored/removed events to a :class:`KvEventSink` — the same signal the
reference's engines publish for KV-aware routing (SURVEY.md §3.5); the radix
indexer consumes them. Capability parity with the reference's block reuse pool
(lib/llm/src/kv/reuse.rs, prefix_caching in the patched vLLM) — re-designed,
not ported: single-threaded host logic driven by the engine loop.
"""

from __future__ import annotations

from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, Tuple

from ..kv.tokens import TokenBlockSequence, compute_block_hashes_for_seq
from ..runtime import integrity


class KvDtypeMismatch(TypeError):
    """KV pages and the target pool disagree on the storage layout (int8
    pages+scales vs native dtype). Raised instead of writing mismatched
    bytes into the pool — a dtype skew must surface as a clean typed error,
    never as silently corrupt pages. The disagg transfer plane maps it to a
    prefill-failure reply so the decode side falls back to local prefill."""


class MigrationRejected(RuntimeError):
    """A target engine refused to stage a live-migrated stream (out of KV
    blocks, block-size/page-count mismatch, history longer than its
    max_model_len). Typed so the transfer plane's ``migrate`` op nacks
    cleanly and the source degrades that stream to the ordinary resume
    path — never a torn page set (docs/resilience.md §Live migration)."""


class KvEventSink(Protocol):
    """Receiver for KV cache events (worker → router)."""

    def blocks_stored(
        self, parent_hash: Optional[int], blocks: List[Tuple[int, List[int]]]
    ) -> None:
        """blocks: [(block_hash, token_ids), ...] in chain order."""

    def blocks_removed(self, block_hashes: List[int]) -> None: ...


@dataclass
class SequenceAllocation:
    """A live sequence's hold on physical pages."""

    block_ids: List[int]  # physical page ids, logical order
    token_blocks: TokenBlockSequence  # hashing state (tracks sealed blocks)
    cached_tokens: int  # prompt tokens served from prefix cache (any tier)
    sealed_blocks: int = 0  # how many full blocks have been hashed+registered
    # QoS attribution (runtime/qos.py): owning tenant + class level. The
    # allocator sums hard-held blocks per tenant (KV budgets) and tags
    # cached blocks with their owners' level so eviction under pressure
    # reclaims the lowest class first. Both stay at their defaults on the
    # single-tenant path — no per-tenant dict is ever touched.
    tenant: str = ""
    level: int = 0
    # host-tier prefix hits: (logical block index, sequence hash, k, v,
    # k_scale, v_scale, crc) with the content captured at probe time (a
    # later offload into the LRU pool can't invalidate them). The scale
    # entries are None for native-dtype pools and [L, bs] float32 tables
    # for int8 pools — scales travel WITH their pages through every tier;
    # ``crc`` is the seal-time content checksum (None with integrity off),
    # already VERIFIED at probe time. The engine must inject each into
    # block_ids[index] before any compute touches the sequence.
    host_hits: List[Tuple[int, int, Any, Any, Any, Any, Any]] = field(default_factory=list)
    # full-prompt block hashes this sequence advertised as in-flight (it will
    # compute + seal them); unregistered on free if still unsealed
    pending_hashes: List[int] = field(default_factory=list)


class InflightPrefix:
    """Returned by :meth:`BlockAllocator.allocate_sequence` when another live
    sequence is currently computing this prompt's next prefix block: the
    caller should keep the request pending and retry — once the owner seals
    the shared blocks they become ordinary prefix-cache hits, so the shared
    prefill is computed exactly once (reference: the reserved/shared in-flight
    block registry, lib/llm/src/kv/reserved.rs:23-127)."""

    __slots__ = ("seq_hash",)

    def __init__(self, seq_hash: int):
        self.seq_hash = seq_hash


class HostKvPool:
    """Host-RAM tier of the KV cache: evicted device blocks spill here.

    Content-addressed by the same chained sequence hash as the device tier,
    LRU-bounded. TPU analogue of the reference's pinned-host block pool
    (`lib/llm/src/kv/manager.rs:79-124`, `kv/storage.rs` CudaPinnedMemory):
    host arrays re-enter HBM via the engine's donated-scatter inject path.
    """

    def __init__(self, max_blocks: int):
        self.max_blocks = max_blocks
        # hash → (k, v, k_scale, v_scale, crc); scales are None for native-
        # dtype pools and per-token tables for int8 pools — the pool is
        # payload-agnostic so both layouts ride the same LRU. ``crc`` is the
        # block's seal-time content checksum (None with the integrity plane
        # off / from pre-integrity spills): verified at rehit so bad host
        # RAM surfaces as a prefix miss, never as corrupt device pages.
        self._data: "OrderedDict[int, Tuple[Any, Any, Any, Any, Any]]" = OrderedDict()
        self.hits = 0
        self.offloaded = 0

    def __contains__(self, h: int) -> bool:
        return h in self._data

    def __len__(self) -> int:
        return len(self._data)

    def put(self, h: int, k, v, k_scale=None, v_scale=None, crc=None) -> None:
        if h in self._data:
            self._data.move_to_end(h)
            return
        while len(self._data) >= self.max_blocks:
            self._data.popitem(last=False)
        self._data[h] = (k, v, k_scale, v_scale, crc)
        self.offloaded += 1

    def get(self, h: int) -> Optional[Tuple[Any, Any, Any, Any, Any]]:
        item = self._data.get(h)
        if item is not None:
            self._data.move_to_end(h)
            self.hits += 1
        return item

    def discard(self, h: int) -> None:
        """Drop a poisoned entry (failed its rehit checksum): it must never
        be served again — the prompt recomputes instead."""
        self._data.pop(h, None)


class _TieredLru:
    """The reclaimable-block reuse pool, tiered by QoS class level.

    Blocks land in the tier of their (highest) owning class; eviction
    pops the *lowest* tier first, LRU-oldest within a tier — so under KV
    pressure a batch tenant's warm cache is reclaimed before a premium
    tenant's (the reference framework's priority-aware reuse, re-designed
    for the paged pool). With QoS off every block lives in tier 0 and
    behavior is exactly the old single-OrderedDict LRU.
    """

    __slots__ = ("_tiers", "_tier_of", "_size")

    def __init__(self) -> None:
        self._tiers: Dict[int, "OrderedDict[int, None]"] = {}
        self._tier_of: Dict[int, int] = {}
        self._size = 0

    def __contains__(self, bid: int) -> bool:
        return bid in self._tier_of

    def __len__(self) -> int:
        return self._size

    def add(self, bid: int, level: int = 0) -> None:
        """Insert (or refresh) a block as most-recently-used in its tier."""
        old = self._tier_of.get(bid)
        if old is not None:
            od = self._tiers[old]
            del od[bid]
            self._size -= 1
        tier = self._tiers.setdefault(level, OrderedDict())
        tier[bid] = None  # fresh insert lands most-recently-used
        self._tier_of[bid] = level
        self._size += 1

    def discard(self, bid: int) -> bool:
        level = self._tier_of.pop(bid, None)
        if level is None:
            return False
        del self._tiers[level][bid]
        self._size -= 1
        return True

    def pop_oldest(self) -> Optional[int]:
        """Evict: lowest class level first, LRU-oldest within the level."""
        if self._size == 0:
            return None
        for level in sorted(self._tiers):
            od = self._tiers[level]
            if od:
                bid, _ = od.popitem(last=False)
                del self._tier_of[bid]
                self._size -= 1
                return bid
        return None


class BlockAllocator:
    """Allocates physical pages, reuses prefix-cached ones, evicts LRU
    (class-tiered when QoS levels flow — see :class:`_TieredLru`).

    All methods are called from the engine's step loop (single thread).
    """

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        event_sink: Optional[KvEventSink] = None,
        salt: Optional[bytes] = None,
        host_pool: Optional[HostKvPool] = None,
        offload: Optional[Callable[[List[Tuple[int, int, Any]]], None]] = None,
        checksum: Optional[Callable[[List[int]], List[Any]]] = None,
    ):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.salt = salt
        self._sink = event_sink
        # host tier: `offload([(hash, block_id), ...])` is called while the
        # evicted blocks' device contents are still valid; the engine copies
        # them into `host_pool` (device_get) before they can be overwritten
        self.host_pool = host_pool
        self._offload = offload
        # integrity plane (runtime/integrity.py): ``checksum([block_ids])``
        # is the engine's callback giving the content checksums of freshly
        # SEALED blocks, as ints or as futures of ints that the engine
        # resolves off its thread (``resolve_crc`` waits for one). None =
        # integrity off: no crc is ever computed, stored, or verified.
        self._checksum = checksum
        self._crc_of: Dict[int, Any] = {}  # physical page id → seal crc
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._refcount: Dict[int, int] = {}
        # sequence_hash → block id, for every block whose contents are valid
        self._by_hash: Dict[int, int] = {}
        self._hash_of: Dict[int, int] = {}  # block id → sequence hash
        # refcount-0 blocks with valid contents, eviction order = lowest
        # class tier first, LRU within a tier (all tier 0 with QoS off)
        self._cached = _TieredLru()
        # QoS (runtime/qos.py): hard-held blocks per tenant (the KV-budget
        # signal) and the class level a block carries into the reuse pool
        # (max over owners — a premium tenant's shared prefix must not be
        # evicted early because a batch tenant also used it). Both dicts
        # stay empty on the single-tenant path.
        self.tenant_blocks: Dict[str, int] = {}
        self._block_level: Dict[int, int] = {}
        # in-flight registry: sequence hash → physical page a live sequence
        # is about to compute into. A concurrent request sharing that prefix
        # waits for the seal instead of prefilling the same content twice.
        self._inflight: Dict[int, int] = {}
        # counters for metrics
        self.hit_tokens = 0
        self.probe_tokens = 0
        self.inflight_waits = 0  # admission deferrals onto an in-flight prefill
        self.shared_prefill_tokens = 0  # tokens served by joining one
        # live occupancy accounting (PR6 telemetry): high-water mark of
        # hard-held (refcounted) blocks and cumulative acquisitions. Peak
        # near num_blocks under normal load means the pool — not slots —
        # is the binding capacity constraint (feeds the SLA planner's
        # pool-resize decision, ROADMAP item 4).
        self.peak_active_blocks = 0
        self.blocks_acquired_total = 0

    def set_sink(self, sink: Optional[KvEventSink]) -> None:
        self._sink = sink

    # -- queries -------------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free) + len(self._cached)

    @property
    def active_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def reclaimable_blocks(self) -> int:
        """Blocks with valid contents but refcount 0 (the LRU reuse pool).
        They count as *free* for admission — allocation can evict them — but
        evicting costs future prefix-cache hits; exported separately so the
        overload dashboards can tell hard headroom from warm cache."""
        return len(self._cached)

    def usage(self) -> float:
        return self.active_blocks / self.num_blocks if self.num_blocks else 0.0

    def inflight_pending(self, seq_hash: int) -> bool:
        """Is a live sequence still mid-prefill on this block hash? (Cheap
        check a parked request uses to avoid re-probing its whole prompt.)"""
        return seq_hash in self._inflight

    def hash_of_block(self, block_id: int) -> int:
        """Registered content hash of a physical page, or -1 (free/partial/
        reused pages have none)."""
        return self._hash_of.get(block_id, -1)

    def crc_of_block(self, block_id: int) -> int:
        """Seal-time content checksum of a physical page, or -1 (unsealed,
        or sealed while the integrity plane was off); waits for a checksum
        that is still being computed."""
        crc = self._crc_of.get(block_id)
        return -1 if crc is None else resolve_crc(crc)

    def blocks_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.block_size - 1) // self.block_size

    def can_allocate(self, n_tokens: int) -> bool:
        # conservative: ignores potential prefix hits
        return self.blocks_needed(n_tokens) <= self.free_blocks

    # -- allocation ----------------------------------------------------------

    def allocate_sequence(
        self, token_ids: Sequence[int], wait_inflight: bool = True,
        tenant: str = "", level: int = 0,
    ) -> Optional[SequenceAllocation]:
        """Allocate pages for a prompt, reusing prefix-cached blocks.

        Returns None if not enough pages are available (caller re-queues),
        or an :class:`InflightPrefix` when ``wait_inflight`` and another live
        sequence is mid-prefill on this prompt's next prefix block (caller
        re-queues; after the owner seals, the retry turns into ordinary
        prefix hits — one prefill compute for N concurrent identical
        prefixes). The last prompt token is never served from cache: its
        logits are needed to sample the first output token, so at least one
        position is computed.
        """
        seq_hashes = compute_block_hashes_for_seq(token_ids, self.block_size, self.salt)
        self.probe_tokens += len(token_ids)

        # longest cached prefix (block-aligned, capped so ≥1 token is computed)
        max_cacheable = min(len(seq_hashes), (len(token_ids) - 1) // self.block_size)
        reused: List[int] = []
        for h in seq_hashes[:max_cacheable]:
            bid = self._by_hash.get(h)
            if bid is None:
                break
            reused.append(bid)

        # host tier continues the chain where the device tier missed; content
        # is captured now so later evictions from the pool can't invalidate
        # it. With the integrity plane on, each entry's bytes are verified
        # against its seal-time checksum HERE: a corrupted entry (bad host
        # RAM) is dropped from the pool and treated as a prefix miss, the
        # chain ends and the prompt recomputes from there.
        host_hits: List[Tuple[int, int, Any, Any, Any, Any, Any]] = []
        if self.host_pool is not None:
            j = len(reused)
            while j < max_cacheable:
                item = self.host_pool.get(seq_hashes[j])
                if item is None:
                    break
                if self._checksum is not None and item[4] is not None:
                    if integrity.entry_checksum(*item[:4]) != item[4]:
                        self.host_pool.discard(seq_hashes[j])
                        integrity.note_trip("kv", where="host_rehit")
                        break
                host_hits.append((j, seq_hashes[j]) + tuple(item))
                j += 1

        # shared in-flight prefill: if the next missing block is being
        # computed RIGHT NOW by a live sequence, don't prefill it again
        j0 = len(reused) + len(host_hits)
        if wait_inflight and j0 < max_cacheable and seq_hashes[j0] in self._inflight:
            self.inflight_waits += 1
            return InflightPrefix(seq_hashes[j0])

        # acquire matches FIRST so LRU eviction below can't reclaim them
        for bid in reused:
            self._acquire(bid)

        n_fresh = self.blocks_needed(len(token_ids)) - len(reused)
        if not self._reserve_capacity(n_fresh):
            for bid in reused:  # roll back
                self._release_one(bid)
            return None

        block_ids = list(reused) + [self._take_free() for _ in range(n_fresh)]
        cached_tokens = (len(reused) + len(host_hits)) * self.block_size
        self.hit_tokens += cached_tokens

        # host-hit blocks become valid device content once the engine injects
        # them; register their hashes so the next request hits the device tier
        stored: List[Tuple[int, List[int]]] = []
        for idx, h, *rest in host_hits:
            bid = block_ids[idx]
            prior = self._hash_of.get(bid)
            if prior is not None and prior != h:
                self._unregister(bid)
            if h not in self._by_hash:
                self._by_hash[h] = bid
                self._hash_of[bid] = h
                if self._checksum is not None and rest[4] is not None:
                    # the (verified) host entry's seal checksum describes
                    # the bytes about to be injected into this page
                    self._crc_of[bid] = rest[4]
                stored.append(
                    (h, list(token_ids[idx * self.block_size : (idx + 1) * self.block_size]))
                )
        if stored and self._sink is not None:
            parent = seq_hashes[host_hits[0][0] - 1] if host_hits[0][0] > 0 else None
            self._sink.blocks_stored(parent, stored)

        # advertise the full-prompt blocks this sequence will compute so a
        # concurrent request with the same prefix joins instead of recomputing
        pending: List[int] = []
        for idx in range(j0, len(seq_hashes)):
            h = seq_hashes[idx]
            if h not in self._by_hash and h not in self._inflight:
                self._inflight[h] = block_ids[idx]
                pending.append(h)

        # QoS attribution: budget accounting + eviction-tier tagging (both
        # no-ops on the single-tenant path — tenant ""/level 0)
        if tenant:
            self.tenant_blocks[tenant] = (
                self.tenant_blocks.get(tenant, 0) + len(block_ids)
            )
        if level > 0:
            for bid in block_ids:
                if self._block_level.get(bid, 0) < level:
                    self._block_level[bid] = level

        # hashing state covers only tokens whose KV exists (the cached prefix);
        # note_tokens_computed extends it as prefill/decode computes the rest
        return SequenceAllocation(
            block_ids=block_ids,
            token_blocks=TokenBlockSequence(
                token_ids[:cached_tokens], self.block_size, salt=self.salt
            ),
            cached_tokens=cached_tokens,
            sealed_blocks=len(reused) + len(host_hits),
            host_hits=host_hits,
            pending_hashes=pending,
            tenant=tenant,
            level=level,
        )

    def grow(self, alloc: SequenceAllocation, n_tokens: int) -> bool:
        """Ensure capacity for a sequence now ``n_tokens`` long (decode growth)."""
        needed = self.blocks_needed(n_tokens)
        while len(alloc.block_ids) < needed:
            if not self._reserve_capacity(1):
                return False
            bid = self._take_free()
            alloc.block_ids.append(bid)
            if alloc.tenant:
                self.tenant_blocks[alloc.tenant] = (
                    self.tenant_blocks.get(alloc.tenant, 0) + 1
                )
            if alloc.level > 0 and self._block_level.get(bid, 0) < alloc.level:
                self._block_level[bid] = alloc.level
        return True

    def note_tokens_computed(self, alloc: SequenceAllocation, token_ids: Sequence[int]) -> None:
        """Record that KV for these tokens now exists in the sequence's pages.

        Seals any blocks that became full: registers their hashes for reuse and
        emits a `stored` event (chain order preserved).
        """
        sealed = alloc.token_blocks.extend(token_ids)
        if not sealed:
            return
        stored: List[Tuple[int, List[int]]] = []
        parent = sealed[0].parent_hash
        for blk in sealed:
            bid = alloc.block_ids[blk.position]
            self._inflight.pop(blk.block_hash, None)  # promise fulfilled
            prior = self._hash_of.get(bid)
            if prior is not None and prior != blk.block_hash:
                self._unregister(bid)  # drops the stale class tag too
                if alloc.level > 0:
                    # the sealing owner's level governs the fresh content
                    self._block_level[bid] = alloc.level
            if blk.block_hash not in self._by_hash:
                self._by_hash[blk.block_hash] = bid
                self._hash_of[bid] = blk.block_hash
                stored.append((blk.block_hash, list(blk.tokens)))
        alloc.sealed_blocks = len(alloc.token_blocks.blocks)
        if self._checksum is not None and stored:
            # seal-time content checksums: computed once, while the owner
            # can still vouch for the bytes; they travel with the block into
            # the host tier
            bids = [self._by_hash[h] for h, _ in stored]
            for bid, crc in zip(bids, self._checksum(bids)):
                self._crc_of[bid] = crc
        if stored and self._sink is not None:
            self._sink.blocks_stored(parent, stored)

    def free_sequence(self, alloc: SequenceAllocation) -> None:
        """Release a finished sequence's pages. Hash-registered blocks become
        reusable cache; unhashed (partial) blocks return to the free list.
        Unfulfilled in-flight promises are withdrawn so a waiting request
        stops waiting and computes the prefix itself."""
        own = set(alloc.block_ids)
        for h in alloc.pending_hashes:
            if self._inflight.get(h) in own:
                self._inflight.pop(h, None)
        alloc.pending_hashes = []
        if alloc.tenant and alloc.block_ids:
            left = self.tenant_blocks.get(alloc.tenant, 0) - len(alloc.block_ids)
            if left > 0:
                self.tenant_blocks[alloc.tenant] = left
            else:
                self.tenant_blocks.pop(alloc.tenant, None)
        for bid in alloc.block_ids:
            self._release_one(bid)
        alloc.block_ids = []

    # -- internals -----------------------------------------------------------

    def _release_one(self, bid: int) -> None:
        rc = self._refcount.get(bid, 0) - 1
        if rc > 0:
            self._refcount[bid] = rc
            return
        self._refcount.pop(bid, None)
        if bid in self._hash_of:
            # reuse pool, tiered by the owners' class level: lowest class
            # evicted first under pressure (0 for everything with QoS off)
            self._cached.add(bid, self._block_level.get(bid, 0))
        else:
            self._block_level.pop(bid, None)
            self._free.append(bid)

    def _acquire(self, bid: int) -> None:
        self._cached.discard(bid)  # revive from reuse pool
        self._refcount[bid] = self._refcount.get(bid, 0) + 1
        self._note_occupancy()

    def _take_free(self) -> int:
        bid = self._free.pop()
        self._refcount[bid] = 1
        self._note_occupancy()
        return bid

    def _note_occupancy(self) -> None:
        self.blocks_acquired_total += 1
        active = self.active_blocks
        if active > self.peak_active_blocks:
            self.peak_active_blocks = active

    def peak_occupancy(self) -> float:
        """High-water fraction of the pool ever hard-held at once."""
        return (
            self.peak_active_blocks / self.num_blocks if self.num_blocks else 0.0
        )

    def _reserve_capacity(self, n: int) -> bool:
        """Make sure the free list has n entries, evicting LRU cached blocks.

        Evicted blocks spill to the host tier (offload callback copies their
        still-valid device contents) before their pages are reusable."""
        evicted: List[int] = []
        spill: List[Tuple[int, int, Any]] = []
        while len(self._free) < n:
            bid = self._cached.pop_oldest()  # lowest class tier, then LRU
            if bid is None:
                return False
            h = self._hash_of.pop(bid)
            del self._by_hash[h]
            self._block_level.pop(bid, None)
            evicted.append(h)
            # the seal-time checksum follows the content into the host tier
            # (verified at rehit); the page itself is being recycled
            crc = self._crc_of.pop(bid, None)
            if self._offload is not None and self.host_pool is not None:
                if h not in self.host_pool:
                    spill.append((h, bid, crc))
            self._free.append(bid)
        if spill:
            self._offload(spill)
        if evicted and self._sink is not None:
            self._sink.blocks_removed(evicted)
        return True

    def _unregister(self, bid: int) -> None:
        h = self._hash_of.pop(bid, None)
        if h is not None:
            self._by_hash.pop(h, None)
            if self._sink is not None:
                self._sink.blocks_removed([h])
        # content replaced ⇒ its seal checksum no longer describes the page
        self._crc_of.pop(bid, None)
        self._cached.discard(bid)
        # the block's content is being replaced: its class tag must not
        # survive into the new owner's tier (levels only ever go UP via
        # allocate/grow — a stale high tag would shelter a low-class
        # block from eviction forever)
        self._block_level.pop(bid, None)


def resolve_crc(crc: Any) -> Optional[int]:
    """A seal checksum as an int: a future (computed off the engine thread)
    is waited for; None stays None."""
    return crc.result() if isinstance(crc, Future) else crc

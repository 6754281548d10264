"""Unified paged KV pool (paper §3.5.2).

Host-side block allocator shared by the prefill and decode engines: the
prefill engine allocates blocks and fills them; migration to decode passes
*block indices only* (copy-free, the cudaIpc-shared-pool analogue). The
block ids index the engine's *device* page pools directly — prefill
scatters KV straight into pooled pages, the paged decode kernel gathers
them via the :meth:`PagedKVPool.device_block_table` export, and preempt/
resume/migrate move block ownership in this table instead of copying or
re-laying-out device rows. (Engines may also run a dense per-slot cache,
in which case this allocator is admission bookkeeping only.)

Shared-prefix KV reuse (``share_prefix=True``, docs/KV_SHARING.md): the
pool additionally keeps a **radix index over prompt-aligned page runs** —
each indexed block is one full page of a previously served prompt, keyed
by its page of token ids and chained to its predecessor page. A new
request whose prompt walks a chain of indexed pages maps those pages
read-shared into its own table at admission (refcounted), recomputes only
the unshared suffix, and pays copy-on-write for a partially-matching tail
page. Freeing is refcount-aware: a block returns to the free list only at
refcount zero, and ref-0 *indexed* blocks are retained on an LRU cache
(evicted back to free on demand) so the prefix survives its first owner.

Invariants (property-tested in tests/test_kvcache.py and
tests/test_prefix_sharing.py):
  - referenced, cached, and free blocks partition the pool;
  - a block's refcount equals the number of page tables containing it;
  - a request's pages cover exactly ceil(len / block_size) blocks;
  - freeing is idempotent per request;
  - every indexed block is referenced or cached (never free).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class OutOfBlocks(RuntimeError):
    pass


@dataclass
class PageTable:
    rid: int
    blocks: List[int] = field(default_factory=list)
    n_tokens: int = 0
    #: leading tokens whose KV was reused from the prefix index at
    #: admission (shared full pages + the copied tail); prefill covers
    #: only the suffix past them
    shared_tokens: int = 0
    #: leading blocks mapped read-shared (refcount may exceed 1)
    shared_blocks: int = 0
    #: (src, dst) copy-on-write page pairs the engine must copy on device
    #: before the first divergent write lands in ``dst``
    cow_pairs: List[Tuple[int, int]] = field(default_factory=list)


@dataclass
class PoolOps:
    """Always-on operation counters (allocator events, not block counts)
    absorbed into the metrics registry by Observability.sync_engine_stats
    — table mutations are host-side bookkeeping, so counting them here is
    free and keeps the allocator zero-dependency."""
    allocs: int = 0
    extends: int = 0
    frees: int = 0
    preempts: int = 0
    #: prefix-sharing events (docs/KV_SHARING.md)
    shared_hits: int = 0       # allocations that mapped shared prefix pages
    reused_tokens: int = 0     # cumulative tokens served from shared pages
    cow_copies: int = 0        # copy-on-write tail pages
    evictions: int = 0         # cached (ref-0) pages reclaimed for space
    registers: int = 0         # register_prefix calls that indexed >=1 page


class PagedKVPool:
    def __init__(self, total_tokens: int, block_size: int = 16,
                 share_prefix: bool = False):
        assert block_size > 0 and total_tokens >= block_size
        self.block_size = block_size
        self.share_prefix = share_prefix
        self.n_blocks = total_tokens // block_size
        self._free: List[int] = list(range(self.n_blocks))
        self._tables: Dict[int, PageTable] = {}
        #: block -> number of page tables currently containing it
        self._refs: Dict[int, int] = {}
        #: ref-0 indexed blocks retained for future prefix hits, LRU order
        #: (oldest first — evicted back to the free list on demand)
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        #: radix index at page granularity: parent block id (None = root)
        #: -> {page of token ids -> child block id}
        self._children: Dict[Optional[int], Dict[Tuple[int, ...], int]] = {}
        #: reverse index: block -> (parent, key) for unindexing
        self._node: Dict[int, Tuple[Optional[int], Tuple[int, ...]]] = {}
        self.ops = PoolOps()

    # -- capacity ------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Ref-0 indexed blocks retained for prefix hits (reclaimable)."""
        return len(self._cached)

    @property
    def available_blocks(self) -> int:
        """Blocks an allocation can draw on: free plus evictable cached."""
        return len(self._free) + len(self._cached)

    @property
    def allocated_blocks(self) -> int:
        return self.n_blocks - len(self._free) - len(self._cached)

    def occupancy(self) -> float:
        """Fraction of pool blocks currently allocated to requests."""
        return self.allocated_blocks / max(self.n_blocks, 1)

    def fragmentation(self) -> float:
        """Internal fragmentation: the fraction of allocated block
        capacity not (yet) covered by tokens — reservation-ahead slack
        plus last-block padding. 0 when nothing is allocated. (Shared
        blocks are counted once on the capacity side but per-reader on
        the token side, so heavy sharing drives this toward 0.)"""
        cap = self.allocated_blocks * self.block_size
        if cap <= 0:
            return 0.0
        used = sum(t.n_tokens for t in self._tables.values())
        return max(0.0, 1.0 - used / cap)

    @property
    def free_tokens(self) -> int:
        return self.free_blocks * self.block_size

    def can_admit(self, n_tokens: int) -> bool:
        return self._blocks_for(n_tokens) <= self.available_blocks

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to cover ``n_tokens``."""
        return self._blocks_for(n_tokens)

    def _blocks_for(self, n: int) -> int:
        return -(-n // self.block_size)

    # -- refcount plumbing ---------------------------------------------
    def _acquire(self, block: int) -> None:
        """One more table holds ``block``; a cached block comes back live."""
        self._refs[block] = self._refs.get(block, 0) + 1
        self._cached.pop(block, None)

    def _release(self, block: int) -> None:
        """One table dropped ``block``; at refcount zero it is retained on
        the cached LRU while indexed (its content may serve a future
        prefix hit), else returned to the free list."""
        c = self._refs[block] - 1
        if c > 0:
            self._refs[block] = c
            return
        del self._refs[block]
        if block in self._node:
            self._cached[block] = None        # most-recently-used end
        else:
            self._free.append(block)

    def _unindex_subtree(self, block: int) -> None:
        """Drop ``block``'s index entry and every entry reachable below it
        (a page is only matchable through its full prefix chain, so the
        subtree is dead once the root's content is reclaimed). Cached
        descendants lose their reason to exist and return to free."""
        parent, key = self._node.pop(block)
        kids = self._children.get(parent)
        if kids is not None:
            kids.pop(key, None)
            if not kids:
                self._children.pop(parent, None)
        stack = [block]
        while stack:
            cur = stack.pop()
            for child in self._children.pop(cur, {}).values():
                self._node.pop(child, None)
                if child in self._cached:
                    del self._cached[child]
                    self._free.append(child)
                stack.append(child)

    def _take_free(self) -> int:
        """Pop a writable block, evicting the least-recently-used cached
        prefix page when the free list is empty."""
        if self._free:
            return self._free.pop()
        if self._cached:
            victim = next(iter(self._cached))
            del self._cached[victim]
            self._unindex_subtree(victim)
            self._free.append(victim)
            self.ops.evictions += 1
            return self._free.pop()
        raise OutOfBlocks("no free or cached blocks left")

    # -- prefix index (share_prefix=True) -------------------------------
    def match_prefix(self, tokens: Sequence[int]
                     ) -> Tuple[List[int], int, Optional[Tuple[int, int]]]:
        """Longest indexed prefix of ``tokens`` at page granularity.

        Returns ``(blocks, matched_tokens, cow)``: the chain of fully
        matched pages, the token count they cover, and — when the next
        page diverges partway — ``cow = (src_block, tail_tokens)`` naming
        the indexed page whose first ``tail_tokens`` ids still match (the
        caller copies it and overwrites from the divergence point on).
        Matching is capped at ``len(tokens) - 1`` so a fully-cached prompt
        still prefills at least one token (the next-token logits must be
        computed from something). Non-mutating."""
        if not self.share_prefix:
            return [], 0, None
        toks = [int(t) for t in tokens]
        ps = self.block_size
        max_match = len(toks) - 1
        blocks: List[int] = []
        parent: Optional[int] = None
        matched = 0
        while matched + ps <= max_match:
            key = tuple(toks[matched:matched + ps])
            child = self._children.get(parent, {}).get(key)
            if child is None:
                break
            blocks.append(child)
            parent = child
            matched += ps
        # partial tail: the best partially-agreeing child page is COW'd
        cow = None
        best = 0
        rest = toks[matched:]
        for key, child in self._children.get(parent, {}).items():
            n = 0
            for a, b in zip(key, rest):
                if a != b:
                    break
                n += 1
            if n > best:
                best, cow = n, (child, n)
        if cow is not None:
            take = min(best, max_match - matched)
            cow = (cow[0], take) if take > 0 else None
        return blocks, matched, cow

    def register_prefix(self, rid: int, tokens: Sequence[int]) -> int:
        """Index ``rid``'s written pages under their token content so later
        prompts can map them read-shared. ``tokens`` are the ids whose KV
        actually sits in ``rid``'s pages (prompt + generated prefix minus
        the last sampled token); only full pages are indexed. Idempotent;
        on duplicate content the first registration wins and the walk
        continues through the winner's chain. Returns pages indexed."""
        table = self._tables.get(rid)
        if not self.share_prefix or table is None:
            return 0
        toks = [int(t) for t in tokens]
        ps = self.block_size
        parent: Optional[int] = None
        added = 0
        for i in range(min(len(toks) // ps, len(table.blocks))):
            key = tuple(toks[i * ps:(i + 1) * ps])
            kids = self._children.setdefault(parent, {})
            existing = kids.get(key)
            if existing is not None:
                parent = existing
                continue
            block = table.blocks[i]
            if block in self._node:       # already indexed under another key
                parent = block
                continue
            kids[key] = block
            self._node[block] = (parent, key)
            parent = block
            added += 1
        if added:
            self.ops.registers += 1
        return added

    def flush_shared(self) -> int:
        """Drop the prefix index and return every cached page to the free
        list — the paged→dense degradation rung calls this after unwinding
        all in-flight work (docs/RESILIENCE.md). Refuses while any page is
        still mapped by more than one reader: tearing the index down under
        live sharing would let a later re-admission overwrite pages another
        request is reading. Returns the number of blocks freed."""
        shared = sorted(b for b, c in self._refs.items() if c > 1)
        if shared:
            raise RuntimeError(
                f"cannot flush shared-prefix state: blocks {shared} are "
                "mapped by multiple live readers; unwind them first")
        self._children.clear()
        self._node.clear()
        n = len(self._cached)
        self._free.extend(self._cached)
        self._cached.clear()
        return n

    # -- allocation ----------------------------------------------------
    def allocate(self, rid: int, n_tokens: int,
                 prompt_tokens: Optional[Sequence[int]] = None) -> PageTable:
        """Allocate pages for a request's prompt (prefill admission).

        With ``share_prefix`` and ``prompt_tokens``, pages holding a
        previously indexed prefix of the prompt are mapped read-shared
        (refcount bumped) instead of freshly allocated; a partially
        matching tail page becomes a copy-on-write pair the engine copies
        on device before scattering the suffix."""
        if rid in self._tables:
            raise ValueError(f"rid {rid} already has a page table")
        need = self._blocks_for(n_tokens)
        shared: List[int] = []
        matched = 0
        cow = None
        if self.share_prefix and prompt_tokens is not None:
            shared, matched, cow = self.match_prefix(prompt_tokens)
        fresh_needed = need - len(shared)
        # a cached matched block supplies itself, not the free pool
        avail = self.available_blocks - sum(
            1 for b in shared if b in self._cached)
        if fresh_needed > avail:
            raise OutOfBlocks(
                f"need {fresh_needed} fresh blocks, have {avail}")
        for b in shared:
            self._acquire(b)
        table = PageTable(rid, list(shared), n_tokens,
                          shared_tokens=matched,
                          shared_blocks=len(shared))
        if cow is not None and fresh_needed > 0:
            src, tail = cow
            dst = self._take_free()
            self._acquire(dst)
            table.blocks.append(dst)
            table.cow_pairs.append((src, dst))
            table.shared_tokens += tail
            fresh_needed -= 1
            self.ops.cow_copies += 1
        for _ in range(fresh_needed):
            b = self._take_free()
            self._acquire(b)
            table.blocks.append(b)
        self._tables[rid] = table
        self.ops.allocs += 1
        if table.shared_tokens:
            self.ops.shared_hits += 1
            self.ops.reused_tokens += table.shared_tokens
        return table

    def extend(self, rid: int, n_new_tokens: int = 1) -> PageTable:
        """Grow a request during decode; allocates a block on boundary."""
        table = self._tables[rid]
        new_total = table.n_tokens + n_new_tokens
        need = self._blocks_for(new_total) - len(table.blocks)
        if need > self.available_blocks:
            raise OutOfBlocks(
                f"need {need} blocks, have {self.available_blocks}")
        for _ in range(need):
            b = self._take_free()
            self._acquire(b)
            table.blocks.append(b)
        table.n_tokens = new_total
        self.ops.extends += 1
        return table

    def migrate(self, rid: int) -> PageTable:
        """Prefill→decode handoff: returns the page table (indices only —
        no data movement; both engines map the same pool)."""
        return self._tables[rid]

    def preempt(self, rid: int) -> int:
        """Decode→queue eviction under KV pressure (§3.5.2): release all of
        the victim's blocks and return how many tokens they covered. The
        caller requeues the request with its generated prefix; re-admission
        reserves fresh blocks for prompt + prefix + remaining output.
        Refcount-aware: a page other readers still map merely drops one
        reference — it is never torn out from under them."""
        table = self._tables.get(rid)
        held = table.n_tokens if table is not None else 0
        if table is not None:
            self.ops.preempts += 1
        self.free(rid)
        return held

    def free(self, rid: int) -> int:
        """Release a finished request's blocks. Idempotent. Each block
        drops one reference; blocks reaching refcount zero return to the
        free list (or the cached LRU while still prefix-indexed)."""
        table = self._tables.pop(rid, None)
        if table is None:
            return 0
        for b in table.blocks:
            self._release(b)
        n = len(table.blocks)
        table.blocks = []
        self.ops.frees += 1
        return n

    def reclaimable_blocks(self, rid: int) -> int:
        """Blocks that freeing/preempting ``rid`` would actually make
        available: those it holds the only reference to. Shared pages
        survive the preemption, so they must not count toward a
        pool-pressure shortfall."""
        table = self._tables.get(rid)
        if table is None:
            return 0
        return sum(1 for b in table.blocks if self._refs.get(b, 0) == 1)

    def table(self, rid: int) -> Optional[PageTable]:
        return self._tables.get(rid)

    def owners(self) -> List[int]:
        """The rids currently holding pool blocks — the engine invariant
        checker asserts this is a subset of its live requests (plus any
        fault-injected phantoms), i.e. no dead request leaks pages."""
        return list(self._tables.keys())

    def written_blocks(self, rid: int, n_tokens: int) -> List[int]:
        """The leading blocks of ``rid`` that actually hold written KV —
        ``ceil(n_tokens / block_size)`` of its reservation. A request
        reserves prompt + output up front, but a prefill→decode handoff
        only needs to move the pages the prefill wrote; decode writes its
        future tokens into the remaining reserved blocks on the far side
        directly."""
        table = self._tables.get(rid)
        if table is None:
            return []
        return table.blocks[:self._blocks_for(max(n_tokens, 0))]

    def device_block_table(self, slot_rids: Sequence[Optional[int]],
                           max_blocks: int,
                           fill: Optional[int] = None) -> np.ndarray:
        """Device-syncable block table: ``(n_slots, max_blocks)`` int32 of
        physical page ids, row ``s`` holding the pages of the request in
        slot ``s`` (first ``ceil(n_tokens / block_size)`` entries, capped
        at ``max_blocks``). Empty slots and unused entries are ``fill``
        (default: ``n_blocks``, i.e. one-past-the-pool — engines keep a
        trash page there so every entry is a valid gather/scatter target).
        """
        if fill is None:
            fill = self.n_blocks
        tbl = np.full((len(slot_rids), max_blocks), fill, np.int32)
        for s, rid in enumerate(slot_rids):
            t = self._tables.get(rid) if rid is not None else None
            if t is None:
                continue
            blocks = t.blocks[:max_blocks]
            tbl[s, :len(blocks)] = blocks
        return tbl

    def check_invariants(self) -> None:
        # refcount <-> table-membership partition (docs/KV_SHARING.md)
        counts: Dict[int, int] = {}
        for t in self._tables.values():
            assert len(t.blocks) == len(set(t.blocks)), \
                f"rid {t.rid} holds a block twice"
            assert len(t.blocks) == self._blocks_for(t.n_tokens)
            assert t.shared_blocks <= len(t.blocks)
            assert t.shared_tokens <= t.n_tokens
            for b in t.blocks:
                counts[b] = counts.get(b, 0) + 1
        assert counts == self._refs, (
            f"refcounts drifted from table membership: "
            f"{counts} != {self._refs}")
        referenced = set(counts)
        cached = set(self._cached)
        free = set(self._free)
        assert len(self._free) == len(free), "free list duplicates"
        assert referenced.isdisjoint(cached), "cached block still owned"
        assert referenced.isdisjoint(free), "freed block still owned"
        assert cached.isdisjoint(free), "block both cached and free"
        assert referenced | cached | free == set(range(self.n_blocks)), \
            "block leak"
        # index sanity: entries name live-or-cached blocks, links agree
        for block, (parent, key) in self._node.items():
            assert block in referenced or block in cached, \
                f"indexed block {block} is on the free list"
            assert self._children.get(parent, {}).get(key) == block
        for kids in self._children.values():
            for block in kids.values():
                assert block in self._node
        for block in self._cached:
            assert block in self._node, f"cached block {block} unindexed"


# ---------------------------------------------------------------------------
# Per-side device pools: the cross-mesh page handoff (chip granularity)
# ---------------------------------------------------------------------------
# Under chip-granular partitions (launch/submesh.py) the engine keeps TWO
# device page pools addressed by the same logical block ids of one
# PagedKVPool: a prefill-staging pool on the prefill side's device and the
# decode pool on the decode side's. Prefill scatters prompt KV into its own
# side's pages; when a prompt finishes, ``transfer_pages`` copies exactly
# the written pages onto the decode side: the copy below IS the
# interconnect traffic the estimator's ``kv_handoff_time`` charges. Block
# ownership never moves: the single host allocator keeps page ids stable
# across the copy, so preempt / resume / migrate stay pure table edits on
# both sides.

def on_stream(stream):
    """The context that makes ``stream`` current (None: none, as on the
    CPU)."""
    import contextlib

    import torch
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def transfer_pages(src_cache, dst_cache, blocks: Sequence[int],
                   placement=None, fault=None, *, streams=None):
    """Prefill→decode KV handoff: for every leaf of every layer of the
    source page pool (``(R, P+1, ps, K, D)``, the page axis dim 1), select
    ``blocks``, copy them to ``placement`` (the decode pool's device; None:
    the destination leaf's own) and ``index_copy_`` them into the
    destination pool in place. Returns ``dst_cache``.

    ``fault`` is the resilience seam (docs/RESILIENCE.md): a callable
    invoked as ``fault(len(blocks))`` before any device work, so an
    injected ``HandoffError`` raised from it leaves both pools untouched
    and the engine's retry re-attempts the identical transfer. Empty
    ``blocks`` is a no-op.

    ``streams`` (CUDA): the (prefill side's, decode side's) streams. The
    pages are selected on the prefill side's stream, after the prefill
    work queued there; the copy and the write run on the decode side's
    stream after an event recorded on the prefill side's. A tensor used
    on a stream it was not made on is marked with ``record_stream``, so
    the caching allocator does not hand its memory out early. The block
    ids reach a card from pinned memory without a host wait, so the
    handoff only queues work on the two streams."""
    if not len(blocks):
        return dst_cache
    if fault is not None:
        fault(len(blocks))
    import torch

    p_stream, d_stream = streams if streams is not None else (None, None)
    idx = torch.as_tensor(np.asarray(blocks, np.int64))

    def upload(dev):
        if dev.type != "cuda":
            return idx.to(dev)
        return idx.pin_memory().to(dev, non_blocking=True)
    with on_stream(p_stream):
        src_dev = src_cache["blocks"][0]["k"].device
        idx_s = upload(src_dev)
        pages = [{key: leaf.index_select(1, idx_s) for key, leaf in e.items()}
                 for e in src_cache["blocks"]]
        ready = p_stream.record_event() if p_stream is not None else None
        with on_stream(d_stream):
            if ready is not None:
                d_stream.wait_event(ready)
            dst_dev = (torch.device(placement) if placement is not None
                       else dst_cache["blocks"][0]["k"].device)
            idx_d = upload(dst_dev)
            for src_entry, dst_entry in zip(pages, dst_cache["blocks"]):
                for key, dst_leaf in dst_entry.items():
                    moved = src_entry[key].to(dst_dev)
                    if d_stream is not None and moved is src_entry[key]:
                        # one card: the pages made on the prefill side's
                        # stream are read on the decode side's
                        moved.record_stream(d_stream)
                    dst_leaf.index_copy_(1, idx_d, moved)
    return dst_cache

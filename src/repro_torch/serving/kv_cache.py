"""Paged, bit-packed KV cache for the serving engine.

Memory layout (per transformer layer, stacked along a leading `layers` axis
by the model's ``page_specs``):

  * ``kp_pages``: (n_pages, H_kv, page_size, d/32) uint32 — keys bit-packed
    exactly as ``core/binarize`` + ``core/bacam.pack_bits`` produce them
    (the paper's Key SRAM holds binarized keys; 6.25% of the bf16 footprint).
  * ``v_pages``:  (n_pages, H_kv, page_size, d) model dtype — fp16/bf16
    values, gathered sparsely (only the top-k selected rows) at attend time.
  * ``k_scale``:  (max_batch, H_kv) float32 — running per-slot/head key
    scale (softmax temperature bookkeeping; per sequence, not per page).

Sequences own *pages*, not contiguous ``max_len`` spans: a slot's logical
token position ``p`` lives at row ``p % page_size`` of physical page
``page_table[slot, p // page_size]``.  The page table is host-managed by a
free-list allocator and shared by every layer (all layers append in
lockstep, vLLM-style), so continuous batching admits requests whenever
pages — not a whole ``max_len`` slot reservation — are available.

Physical page 0 is reserved as the TRASH page: page-table rows of inactive
or padded slots point at it, so their (masked, never-read) cache writes land
somewhere harmless instead of clobbering live sequences.

Copy-on-write prefix sharing
----------------------------

Pages are REFCOUNTED: several slots may alias one physical page (a shared
system-prompt prefix is prefilled once), and a page returns to the free
list only when its last owner releases it.  Sharing is discovered by
hash-based prefix matching at admission:

  * every admitted prompt registers its full pages under a cumulative
    chain key ``(parent_key, page_tokens)`` and its partial last page (if
    any) under ``(chain_key, tail_tokens)``;
  * ``match_prefix`` walks a new prompt down the chain, collecting the
    longest registered prefix.  Fully-covered pages are attached
    read-only (refcount++).  If the match ends mid-page — the page that
    would receive this request's first KV write — that page is FORKED:
    a fresh physical page is allocated and the engine copies the page's
    contents device-side before prefill (copy-on-write, performed eagerly
    at admission because the write is guaranteed).

Shared pages are never written: a sharer's first computed position is
``matched`` and full shared pages only cover positions below it, while
the mid-page boundary case gets a private fork.  The match is always
capped at ``len(prompt) - 1`` so at least one prompt token is computed
(prefill needs a final hidden state to sample from).

Pages registered in the CURRENT admission round are "pending" — their
contents materialize only when their prefill chunks run — so a prompt
matching a pending page reports ``defer=True`` and the engine retries
next tick (with multi-tick chunked prefill a slot's pages stay pending
until its LAST chunk is dispatched; ``commit_pages`` marks them
materialized per slot).

Prefix retention (LRU)
----------------------

A registered page whose refcount drops to zero is not freed: it moves to
a RETAINED pool (its registry entries stay live), so a drained engine
still hash-matches a resubmitted system prompt and reuses the pages
without re-prefilling.  Retained pages are reclaimable: every allocation
draws from the free list first and then evicts the least-recently-
released retained page (dropping its registry keys).  ``free_pages``
therefore counts free + retained — both are available capacity — while
``retained_pages`` exposes the cache depth.  Plan/commit split: all of
this is host-pure bookkeeping; the engine snapshots the page table at
dispatch time, so host-side reservations and evictions never perturb
ticks already in flight (device content of a retained page stays valid
until a later prefill/fork overwrites it, which the dispatch order
guarantees happens only after any copy that still reads it).
"""

from __future__ import annotations

import dataclasses
from collections import Counter, OrderedDict
from typing import Dict, Iterable, List, NamedTuple, Optional, Set, Tuple

import numpy as np

from repro_torch.serving.faults import FaultPlan, NO_FAULTS

__all__ = ["PagedKVCache", "PrefixMatch", "NO_MATCH", "TRASH_PAGE",
           "pages_for"]

TRASH_PAGE = 0  # physical page 0 is never allocated


def pages_for(n_tokens: int, page_size: int) -> int:
    """Number of pages needed to hold n_tokens."""
    return -(-max(n_tokens, 0) // page_size)


class PrefixMatch(NamedTuple):
    """Result of hash-matching a prompt against the registered prefixes."""

    matched: int  # tokens covered by shared pages (+ fork), < len(prompt)
    shared: Tuple[int, ...]  # full pages attached read-only (refcount++)
    fork_src: Optional[int]  # page to copy-on-write fork, or None
    defer: bool  # prefix registered this tick but not yet prefilled


NO_MATCH = PrefixMatch(0, (), None, False)


@dataclasses.dataclass
class PagedKVCache:
    """Host-side page-table + free-list allocator over the device pools.

    The device-side pools themselves live with the engine (they are device
    function state); this object owns which physical page belongs to which
    slot, hands out / reclaims pages, and tracks refcounts + the prefix
    registry for copy-on-write page sharing.
    """

    n_pages: int
    page_size: int
    max_batch: int
    max_pages_per_seq: int
    retain_prefixes: bool = True  # LRU-cache refcount-0 registered pages
    # chaos hook: while `kv.exhaust` is armed the allocator reports an
    # empty pool (level-triggered so capacity checks and allocations
    # agree within a tick).  NO_FAULTS in production.
    faults: FaultPlan = NO_FAULTS

    def __post_init__(self):
        if self.n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        # LIFO free list; page 0 reserved as the trash page.
        self._free: List[int] = list(range(self.n_pages - 1, TRASH_PAGE, -1))
        # refcount-0 pages kept for prefix reuse, LRU order (oldest first).
        self._retained: "OrderedDict[int, None]" = OrderedDict()
        self._owned: List[List[int]] = [[] for _ in range(self.max_batch)]
        self.table = np.full((self.max_batch, self.max_pages_per_seq),
                             TRASH_PAGE, np.int32)
        # page_refs[p] == number of slots whose page table references p;
        # 0 <=> p is free (or the trash page).
        self.page_refs = np.zeros(self.n_pages, np.int32)
        # prefix registry: chain key -> page (full pages), and
        # (chain key, tail tokens) -> (page, rows) for a partial last page.
        self._prefix: Dict[tuple, int] = {}
        self._tail: Dict[tuple, Tuple[int, int]] = {}
        self._page_keys: Dict[int, List[tuple]] = {}  # page -> registry keys
        self._pending: Set[int] = set()  # registered, not yet prefilled

    # -- capacity ------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Reclaimable pages: truly free + retained (evictable) prefixes."""
        return len(self._free) + len(self._retained)

    @property
    def retained_pages(self) -> int:
        """Refcount-0 pages kept alive for prefix reuse (LRU-evictable)."""
        return len(self._retained)

    @property
    def used_pages(self) -> int:
        """UNIQUE physical pages actively owned (shared pages count once;
        retained prefix pages do not count — they are reclaimable)."""
        return (self.n_pages - 1) - self.free_pages

    @property
    def shared_pages(self) -> int:
        """Physical pages currently referenced by more than one slot."""
        return int(np.sum(self.page_refs > 1))

    def occupancy(self, tp: int = 1) -> dict:
        """Page-pool occupancy snapshot, broken out per device for the
        gateway's ``GET /metrics``.

        There is ONE host page table regardless of the tensor-parallel
        degree: under head-sharded serving (serving/sharded.py) every
        device holds ALL pages — each carrying 1/tp of the page's
        kv-head slice — so per-device page occupancy is the allocator's
        global view replicated ``tp`` ways.  Reporting it per device id
        keeps dashboards keyed by device uniform as ``tp`` changes."""
        pool = self.n_pages - 1  # physical pages minus the trash page
        used = self.used_pages
        frac = used / max(pool, 1)
        return {
            "tp": tp,
            "pool_pages": pool,
            "used_pages": used,
            "retained_pages": self.retained_pages,
            "shared_pages": self.shared_pages,
            "per_device": [
                {"device": d, "used_pages": used, "pool_pages": pool,
                 "occupancy": frac}
                for d in range(tp)
            ],
        }

    def _avail_for(self, match: "PrefixMatch" = NO_MATCH) -> int:
        """Pages allocatable while attaching `match`: attached shared
        pages leave the retained pool without consuming an allocation,
        and the fork source is pinned against eviction for the fork
        copy."""
        if self.faults.active("kv.exhaust"):
            return 0
        avail = self.free_pages
        avail -= sum(1 for p in match.shared if p in self._retained)
        if match.fork_src is not None and match.fork_src in self._retained:
            avail -= 1
        return avail

    def can_reserve(self, n_tokens: int, slot: int | None = None,
                    n_shared: int = 0,
                    match: "PrefixMatch" = NO_MATCH) -> bool:
        """Can a (possibly partially-grown) slot cover n_tokens total,
        with ``n_shared`` of its pages attached from the prefix cache?"""
        need = pages_for(n_tokens, self.page_size)
        if need > self.max_pages_per_seq:  # reserve() would refuse
            return False
        have = (len(self._owned[slot]) if slot is not None else 0) + n_shared
        return need - have <= self._avail_for(match)

    # -- alloc / free --------------------------------------------------
    def _alloc_page(self, avoid: Tuple[int, ...] = ()) -> Optional[int]:
        """One page off the free list, else evict the LRU retained prefix
        page (its registry entries are dropped).  ``avoid`` pins pages
        that must survive this allocation (a pending fork source).
        Returns None when nothing is reclaimable."""
        if self.faults.active("kv.exhaust"):
            return None
        if self._free:
            return self._free.pop()
        for page in self._retained:
            if page not in avoid:
                del self._retained[page]
                for kind, key in self._page_keys.pop(page, ()):
                    (self._prefix if kind == "full" else self._tail).pop(
                        key, None)
                return page
        return None

    def reserve(self, slot: int, n_tokens: int) -> None:
        """Grow `slot` to cover n_tokens logical tokens (idempotent)."""
        need = pages_for(n_tokens, self.page_size)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"sequence of {n_tokens} tokens needs {need} pages > "
                f"max_pages_per_seq={self.max_pages_per_seq}")
        owned = self._owned[slot]
        while len(owned) < need:
            page = self._alloc_page()
            if page is None:
                raise MemoryError(
                    f"page pool exhausted growing slot {slot} to "
                    f"{n_tokens} tokens")
            self.page_refs[page] = 1
            self.table[slot, len(owned)] = page
            owned.append(page)

    def release(self, slot: int) -> None:
        """Return `slot`'s page references; free pages that hit refcount 0.

        Releasing a slot that owns nothing is a LOUD error — it means the
        engine double-released or released a slot it never reserved, and
        silently ignoring it would let page-accounting bugs slide until
        two sequences alias the same page.
        """
        if not 0 <= slot < self.max_batch:
            raise ValueError(
                f"release of unknown slot {slot} (max_batch={self.max_batch})")
        owned = self._owned[slot]
        if not owned:
            raise ValueError(
                f"release of slot {slot} which owns no pages "
                "(double release, or a slot that was never reserved)")
        freed: List[int] = []
        for page in owned:
            self.page_refs[page] -= 1
            if self.page_refs[page] == 0:
                # materialized registered pages are RETAINED (LRU) so the
                # prefix stays matchable after its last owner drains;
                # pending pages (prefill never completed) and unregistered
                # pages go straight back to the free list.
                if (self.retain_prefixes and page in self._page_keys
                        and page not in self._pending):
                    self._retained[page] = None  # newest end of the LRU
                    continue
                for kind, key in self._page_keys.pop(page, ()):
                    (self._prefix if kind == "full" else self._tail).pop(
                        key, None)
                self._pending.discard(page)
                freed.append(page)
        self._free.extend(reversed(freed))
        self._owned[slot] = []
        self.table[slot, :] = TRASH_PAGE

    def owned(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    def truncate_to(self, slot: int, length: int) -> List[Tuple[int, int]]:
        """Shrink `slot` to its first `length` logical tokens (speculative-
        decode rollback).  Pages wholly beyond the keep point are released
        exactly like ``release`` (refcount--, retained-or-freed, registry
        entries of freed pages dropped).  The BOUNDARY page — the partial
        page that will receive the slot's next write at row
        ``length % page_size`` — must never be written while shared: if it
        is COW-aliased it is forked (a fresh private page, returned as an
        ``[(src, dst)]`` copy job for the engine's device-side page copy)
        or the call refuses with MemoryError when the pool cannot supply
        the fork page.  Registry entries claiming rows of the kept
        boundary page beyond the keep point are dropped (the slot is about
        to rewrite those rows with different tokens), which keeps
        hash-matching sound after rollback.  Idempotent: truncating twice
        to the same length is a no-op the second time.
        """
        if not 0 <= slot < self.max_batch:
            raise ValueError(
                f"truncate of unknown slot {slot} "
                f"(max_batch={self.max_batch})")
        if length < 0:
            raise ValueError(f"cannot truncate slot {slot} to {length}")
        ps = self.page_size
        owned = self._owned[slot]
        keep = pages_for(length, ps)
        # -- release pages wholly beyond the keep point (release() logic)
        freed: List[int] = []
        for page in owned[keep:]:
            self.page_refs[page] -= 1
            if self.page_refs[page] == 0:
                if (self.retain_prefixes and page in self._page_keys
                        and page not in self._pending):
                    self._retained[page] = None
                    continue
                for kind, key in self._page_keys.pop(page, ()):
                    (self._prefix if kind == "full" else self._tail).pop(
                        key, None)
                self._pending.discard(page)
                freed.append(page)
        self._free.extend(reversed(freed))
        del owned[keep:]
        self.table[slot, keep:] = TRASH_PAGE
        # -- boundary page: kept partially, rewritten from row length%ps
        rows_kept = length % ps
        if not rows_kept or keep - 1 >= len(owned):
            return []
        src = owned[keep - 1]
        forks: List[Tuple[int, int]] = []
        if self.page_refs[src] > 1:
            # never write a shared page: fork it (or refuse).  The source
            # keeps its registry entries and its other owners.
            dst = self._alloc_page(avoid=(src,))
            if dst is None:
                raise MemoryError(
                    f"page pool exhausted forking shared boundary page "
                    f"{src} truncating slot {slot} to {length} tokens")
            self.page_refs[dst] = 1
            self.page_refs[src] -= 1
            owned[keep - 1] = dst
            self.table[slot, keep - 1] = dst
            forks.append((src, dst))
        else:
            # private boundary page: registry claims over rows the slot is
            # about to rewrite are now stale — drop them.
            survivors: List[tuple] = []
            for kind, key in self._page_keys.get(src, ()):
                stale = (kind == "full"
                         or self._tail.get(key, (None, 0))[1] > rows_kept)
                if stale:
                    (self._prefix if kind == "full" else self._tail).pop(
                        key, None)
                else:
                    survivors.append((kind, key))
            if src in self._page_keys:
                if survivors:
                    self._page_keys[src] = survivors
                else:
                    del self._page_keys[src]
                    self._pending.discard(src)
        return forks

    # -- copy-on-write prefix sharing ----------------------------------
    def match_prefix(self, prompt: List[int]) -> PrefixMatch:
        """Longest registered prefix of ``prompt`` (capped at len-1).

        Walks the cumulative chain key over full page_size chunks, then
        tries the registered partial tails of the last matched chain node.
        Touching a page whose prefill has not run yet reports
        ``defer=True`` (admit next tick instead of reading unwritten KV).
        """
        ps = self.page_size
        plen = len(prompt)
        if plen <= 1:
            return NO_MATCH
        key = None
        chain: List[int] = []
        for i in range(plen // ps):
            nxt = (key, tuple(prompt[i * ps:(i + 1) * ps]))
            page = self._prefix.get(nxt)
            if page is None:
                break
            if page in self._pending:
                return PrefixMatch(0, (), None, True)
            key = nxt
            chain.append(page)
        raw = len(chain) * ps
        # longest registered boundary entry that prefixes the remainder
        # (valid at ANY chain node: the entry claims rows [0, length) of
        # its page hold the KV of exactly these tokens at these positions)
        rem = prompt[raw:]
        for length in range(min(len(rem), ps - 1), 0, -1):
            hit = self._tail.get((key, tuple(rem[:length])))
            if hit is None:
                continue
            page, rows = hit
            if page in self._pending:
                return PrefixMatch(0, (), None, True)
            chain.append(page)
            raw += rows
            break
        if raw == 0:
            return NO_MATCH
        matched = min(raw, plen - 1)  # always compute >= 1 prompt token
        n_share = matched // ps
        fork = chain[n_share] if matched % ps else None
        return PrefixMatch(matched, tuple(chain[:n_share]), fork, False)

    def reserve_shared(self, slot: int, match: PrefixMatch,
                       n_tokens: int) -> List[Tuple[int, int]]:
        """Reserve `slot` for n_tokens, attaching the matched prefix.

        Shared full pages are aliased (refcount++); a mid-page match
        allocates a private fork page and returns [(src, dst)] so the
        engine can copy the page contents device-side BEFORE prefill.
        The remainder of the reservation comes from the free list.
        """
        if self._owned[slot]:
            raise ValueError(
                f"reserve_shared on slot {slot} which already owns pages")
        if match.defer:
            raise ValueError("cannot reserve a deferred prefix match")
        need = pages_for(n_tokens, self.page_size)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"sequence of {n_tokens} tokens needs {need} pages > "
                f"max_pages_per_seq={self.max_pages_per_seq}")
        if need - len(match.shared) > self._avail_for(match):
            raise MemoryError(
                f"page pool exhausted reserving slot {slot} "
                f"({need} pages, {len(match.shared)} shared)")
        owned = self._owned[slot]
        for page in match.shared:
            self._retained.pop(page, None)  # revive a drained prefix page
            self.table[slot, len(owned)] = page
            self.page_refs[page] += 1
            owned.append(page)
        forks: List[Tuple[int, int]] = []
        if match.fork_src is not None:
            # the fork source must survive until the engine's device copy
            # runs; pin it against LRU eviction for the dst allocation
            dst = self._alloc_page(avoid=(match.fork_src,))
            assert dst is not None  # _avail_for accounted for the pin
            self.page_refs[dst] = 1
            self.table[slot, len(owned)] = dst
            owned.append(dst)
            forks.append((match.fork_src, dst))
        self.reserve(slot, n_tokens)
        return forks

    def register_prefix(self, slot: int, prompt: List[int]) -> None:
        """Publish `slot`'s prompt pages into the prefix registry
        (first registration of a key wins — later identical prompts
        alias the original pages).  Entries stay PENDING until
        ``commit_prefixes`` marks this round's prefill done.

        Full pages get one chain key each.  The LAST page additionally
        registers every prefix of its contents as a fork point, so a
        later prompt that shares only the first L rows of that page
        (common system prompt, divergent suffix) can COW-fork it instead
        of losing the whole partial page to recompute.
        """
        ps = self.page_size
        owned = self._owned[slot]
        full, rows = len(prompt) // ps, len(prompt) % ps
        keys = [None]  # chain key after i full pages
        for i in range(full):
            keys.append((keys[i], tuple(prompt[i * ps:(i + 1) * ps])))
            if keys[i + 1] in self._prefix:
                continue
            page = owned[i]
            self._prefix[keys[i + 1]] = page
            self._page_keys.setdefault(page, []).append(("full", keys[i + 1]))
            self._pending.add(page)
        if rows:  # partial tail page: its prefixes, tail length included
            node, start, page = keys[full], full * ps, owned[full]
            lengths = range(1, rows + 1)
        elif full:  # page-aligned prompt: proper prefixes of the last page
            node, start, page = keys[full - 1], (full - 1) * ps, owned[full - 1]
            lengths = range(1, ps)
        else:
            return
        for length in lengths:
            tkey = (node, tuple(prompt[start:start + length]))
            if tkey in self._tail:
                continue
            self._tail[tkey] = (page, length)
            self._page_keys.setdefault(page, []).append(("tail", tkey))
            self._pending.add(page)

    def commit_pages(self, pages: Iterable[int]) -> None:
        """Mark `pages` as materialized (their prefill chunks have all
        been dispatched).  With multi-tick chunked prefill each slot
        commits its own pages when its LAST chunk is planned; other
        slots' mid-prefill pages stay pending (and defer matches)."""
        for p in pages:
            self._pending.discard(p)

    def commit_prefixes(self) -> None:
        """Mark EVERY registered page as materialized (single-dispatch
        prefill callers; per-slot callers use ``commit_pages``)."""
        self._pending.clear()

    # -- invariants (chaos harness / crash containment) ----------------
    def invalidate(self, slot: int) -> None:
        """Poison-pill `slot`'s exclusively-owned pages before a crash-
        containment release: a failed device tick may have written
        garbage into them, so their prefix-registry claims are dropped —
        they free instead of retaining, and no later prompt hash-matches
        content that never materialized.  Pages shared with other slots
        (refcount > 1) keep their entries: shared pages are never
        written, so their contents predate the failed tick and stay
        valid for the surviving owners."""
        for page in self._owned[slot]:
            if self.page_refs[page] > 1:
                continue
            for kind, key in self._page_keys.pop(page, ()):
                (self._prefix if kind == "full" else self._tail).pop(key, None)
            self._pending.discard(page)

    def check(self) -> bool:
        """Audit the allocator's standing invariants; AssertionError on
        the first violation, True when the pool balances.  Cheap enough
        to call after every tick in the chaos tests:

          * free + retained + used == n_pages - 1, with the three sets
            pairwise disjoint and the trash page in none of them;
          * ``page_refs[p]`` equals the number of slots owning ``p``
            (so free/retained pages have refcount 0);
          * each slot's page-table row mirrors its owned list (trash
            beyond it);
          * every registry-claimed page is live (owned or retained) and
            every prefix/tail entry's page carries the matching claim.
        """
        errors: List[str] = []
        owned_all = [p for pages in self._owned for p in pages]
        owned, free, retained = (set(owned_all), set(self._free),
                                 set(self._retained))
        if len(free) != len(self._free):
            errors.append("duplicate pages on the free list")
        for name, pages in (("owned", owned), ("free", free),
                            ("retained", retained)):
            if TRASH_PAGE in pages:
                errors.append(f"trash page in {name} set")
            bad = [p for p in pages if not 0 < p < self.n_pages]
            if bad:
                errors.append(f"{name} pages out of range: {bad}")
        for a, b in (("owned", "free"), ("owned", "retained"),
                     ("free", "retained")):
            inter = {"owned": owned, "free": free,
                     "retained": retained}[a] & {
                         "owned": owned, "free": free, "retained": retained}[b]
            if inter:
                errors.append(f"{a}/{b} overlap: {sorted(inter)}")
        total = len(owned) + len(free) + len(retained)
        if total != self.n_pages - 1:
            errors.append(
                f"accounting: used {len(owned)} + free {len(free)} + "
                f"retained {len(retained)} != pool {self.n_pages - 1}")
        refs = Counter(owned_all)
        for p in range(1, self.n_pages):
            if self.page_refs[p] != refs.get(p, 0):
                errors.append(
                    f"page {p}: refcount {int(self.page_refs[p])} != "
                    f"{refs.get(p, 0)} owning slots")
        if self.page_refs[TRASH_PAGE] != 0:
            errors.append("trash page has nonzero refcount")
        for slot, pages in enumerate(self._owned):
            row = self.table[slot]
            if (list(row[:len(pages)]) != pages
                    or any(row[len(pages):] != TRASH_PAGE)):
                errors.append(
                    f"slot {slot}: table row {row.tolist()} does not "
                    f"mirror owned {pages}")
        live = owned | retained
        for page, keys in self._page_keys.items():
            if page not in live:
                errors.append(f"registry claims dead page {page}")
            for kind, key in keys:
                reg = self._prefix if kind == "full" else self._tail
                val = reg.get(key)
                got = val if kind == "full" else (val and val[0])
                if got != page:
                    errors.append(
                        f"page {page}: stale {kind} claim {key!r} -> {val!r}")
        for key, page in self._prefix.items():
            if ("full", key) not in self._page_keys.get(page, ()):
                errors.append(f"prefix entry {key!r} unclaimed by page {page}")
        for key, (page, _) in self._tail.items():
            if ("tail", key) not in self._page_keys.get(page, ()):
                errors.append(f"tail entry {key!r} unclaimed by page {page}")
        if self._pending - set(self._page_keys):
            errors.append(
                f"pending pages without registry claims: "
                f"{sorted(self._pending - set(self._page_keys))}")
        if errors:
            raise AssertionError("PagedKVCache.check: " + "; ".join(errors))
        return True
